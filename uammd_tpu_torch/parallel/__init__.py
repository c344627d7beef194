"""Domain decomposition of the grid engines over a z-slab mesh of shards
(``mesh``, ``domain2``, ``domain``)."""

"""Neighbour search: cell lists, Verlet lists and the pair combinator."""

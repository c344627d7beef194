"""A mesh of shards in one process, and its collectives.

The counterpart of ``jax.sharding.Mesh`` with the collectives that
``shard_map`` bodies call (``ppermute``, ``psum``, ``pmax``,
``all_to_all``, ``axis_index``) and of
``uammd_tpu/parallel/atom.py:make_mesh``.

The JAX package runs a domain-decomposed step as one program per device
under ``shard_map``. Here the mesh stays inside one process: a mesh is a
list of shards, each on a device that the caller names; a per-shard body
becomes phase functions run over the shards, and each collective is the
boundary between two phases, a copy between the shards' tensors. On one
card every shard lives on the same device, so the kernels launch for real
once per shard and the collectives are device-local copies; with several
GPUs the copies become peer copies.

A collective never hands out a tensor that a shard already holds: each
result is a fresh copy on the receiving shard's device, so an in-place
update of it cannot reach the sender's array. The module holds no state.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one device per shard along the named axis."""

    devices: tuple
    axis: str = "z"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_shards: int, axis: str = "z", devices=None) -> Mesh:
    """A mesh of ``n_shards`` shards. ``devices=None`` puts every shard on
    ``resolve_device()`` (the GPU unless the caller passes a list naming
    the CPU); a list must name one device per shard."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n_shards}")
    if devices is None:
        devices = [resolve_device()] * n_shards
    devices = [resolve_device(d) for d in devices]
    if len(devices) != n_shards:
        raise ValueError(f"a {n_shards}-shard mesh needs {n_shards} devices, "
                         f"got {len(devices)}")
    return Mesh(tuple(devices), axis)


def perm_up(n: int) -> list:
    """Each shard sends to i + 1 (receives from its down neighbour)."""
    return [(i, (i + 1) % n) for i in range(n)]


def perm_dn(n: int) -> list:
    """Each shard sends to i - 1 (receives from its up neighbour)."""
    return [(i, (i - 1) % n) for i in range(n)]


def ppermute(shards, perm, devices=None) -> list:
    """``jax.lax.ppermute`` over a list of per-shard tensors: shard ``dst``
    receives a copy of shard ``src``'s tensor for each (src, dst) in
    ``perm``, on the device of its own tensor (or ``devices[dst]``); a
    shard that receives nothing gets zeros, as in JAX."""
    n = len(shards)
    devices = [t.device for t in shards] if devices is None else list(devices)
    out = [None] * n
    for src, dst in perm:
        if out[dst] is not None:
            raise ValueError(f"shard {dst} receives twice in {perm}")
        out[dst] = shards[src].to(devices[dst], copy=True)
    return [torch.zeros_like(shards[i], device=devices[i]) if o is None else o
            for i, o in enumerate(out)]


def _reduce(shards, op) -> list:
    dev0 = shards[0].device
    total = op(torch.stack([t.to(dev0) for t in shards]))
    return [total.to(t.device, copy=True) for t in shards]


def psum(shards) -> list:
    """``jax.lax.psum``: the sum over the shards, one copy per shard."""
    return _reduce(shards, lambda s: s.sum(dim=0))


def pmax(shards) -> list:
    """``jax.lax.pmax``: the largest value over the shards, one copy per
    shard."""
    return _reduce(shards, lambda s: s.max(dim=0).values)


def all_to_all(shards, split_dim: int, concat_dim: int) -> list:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``
    over a list of per-shard tensors: each shard cuts its tensor into as
    many equal chunks along ``split_dim`` as there are shards and sends
    chunk j to shard j; shard j joins what it receives, in the senders'
    order, along ``concat_dim``. Each result is a fresh copy on the
    receiving shard's device."""
    n = len(shards)
    for i, t in enumerate(shards):
        if t.shape[split_dim] % n:
            raise ValueError(f"shard {i}: dim {split_dim} of size {t.shape[split_dim]} does "
                             f"not split into {n} chunks")
    chunks = [torch.chunk(t, n, dim=split_dim) for t in shards]
    return [torch.cat([chunks[src][dst].to(shards[dst].device) for src in range(n)],
                      dim=concat_dim) for dst in range(n)]


def axis_index(mesh: Mesh) -> range:
    """``jax.lax.axis_index``: each shard's position along the axis."""
    return range(mesh.size)

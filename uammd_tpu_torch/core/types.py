"""Precision configuration and common flag structs.

Port of ``uammd_tpu/core/types.py`` (reference: src/global/defines.h:33-43,
src/Interactor/Interactor.cuh:94-103). The working dtype follows the
position tensor; float32 is the default for state this package creates.
"""

from __future__ import annotations

import dataclasses

import torch

#: Default floating dtype for simulation state created by this package.
default_real = torch.float32


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name))


def real_dtype(x):
    """Working float dtype of a tensor, or of the first float tensor in a
    structure of dicts, sequences and dataclasses."""
    if hasattr(x, "dtype"):
        return x.dtype
    for leaf in _leaves(x):
        if leaf.is_floating_point():
            return leaf.dtype
    return default_real


@dataclasses.dataclass(frozen=True)
class Computables:
    """What an interactor should produce (the reference's Computables
    bitfield, Interactor.cuh:94-103)."""

    force: bool = True
    energy: bool = False
    virial: bool = False
    #: per-particle stress tensor, packed [N, 6] as xx, xy, xz, yy, yz, zz
    stress: bool = False


@dataclasses.dataclass
class ForceEnergyVirial:
    """Per-particle outputs of an interactor; fields not requested are None."""

    force: torch.Tensor | None = None  # [N, 3]
    energy: torch.Tensor | None = None  # [N]
    virial: torch.Tensor | None = None  # [N]
    stress: torch.Tensor | None = None  # [N, 6]

    def __add__(self, other: "ForceEnergyVirial") -> "ForceEnergyVirial":
        def add(a, b):
            if a is None:
                return b
            if b is None:
                return a
            return a + b

        return ForceEnergyVirial(
            force=add(self.force, other.force),
            energy=add(self.energy, other.energy),
            virial=add(self.virial, other.virial),
            stress=add(self.stress, other.stress),
        )

    __radd__ = __add__


def zeros_fev(n: int, dtype, computables: Computables, device=None) -> ForceEnergyVirial:
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ForceEnergyVirial(
        force=z(n, 3) if computables.force else None,
        energy=z(n) if computables.energy else None,
        virial=z(n) if computables.virial else None,
        stress=z(n, 6) if computables.stress else None,
    )

"""Particle state: the analog of ParticleData.

Port of ``uammd_tpu/core/state.py`` (reference:
src/ParticleData/ParticleData.cuh:33-46). ``SimState`` is a dataclass of
SoA tensors; unallocated properties are None. The JAX PRNG key becomes a
``torch.Generator`` on the state's device, seeded from ``seed``: the two
packages draw different numbers from the same seed, so tests compare
statistics, or T = 0 trajectories.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .types import default_real


@dataclasses.dataclass
class SimState:
    """SoA particle state; every per-particle tensor has leading dim N."""

    pos: torch.Tensor  # [N, 3]
    gen: torch.Generator
    vel: torch.Tensor | None = None  # [N, 3]
    force: torch.Tensor | None = None  # [N, 3]
    mass: torch.Tensor | None = None  # [N]
    radius: torch.Tensor | None = None  # [N]
    charge: torch.Tensor | None = None  # [N]
    energy: torch.Tensor | None = None  # [N]
    virial: torch.Tensor | None = None  # [N]
    torque: torch.Tensor | None = None  # [N, 3]
    ang_vel: torch.Tensor | None = None  # [N, 3]
    dir: torch.Tensor | None = None  # [N, 4] quaternion
    type_id: torch.Tensor | None = None  # [N] int32 species
    id: torch.Tensor | None = None  # [N] int32 stable identity
    time: torch.Tensor | None = None  # scalar simulation time
    step: torch.Tensor | None = None  # scalar int step counter
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dtype(self):
        return self.pos.dtype

    @property
    def device(self):
        return self.pos.device

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)

    def _ones(self):
        return torch.ones(self.n, dtype=self.dtype, device=self.device)

    def get_mass(self) -> torch.Tensor:
        return self.mass if self.mass is not None else self._ones()

    def get_radius(self) -> torch.Tensor:
        return self.radius if self.radius is not None else self._ones()

    def get_charge(self) -> torch.Tensor:
        return self.charge if self.charge is not None else torch.zeros_like(self._ones())

    def get_vel(self) -> torch.Tensor:
        return self.vel if self.vel is not None else torch.zeros_like(self.pos)

    def get_type(self) -> torch.Tensor:
        if self.type_id is not None:
            return self.type_id
        return torch.zeros(self.n, dtype=torch.int32, device=self.device)

    def get_id(self) -> torch.Tensor:
        if self.id is not None:
            return self.id
        return torch.arange(self.n, dtype=torch.int32, device=self.device)

    def permute(self, perm) -> "SimState":
        """Reorder every per-particle property (built-in and ``extra``) by
        ``perm`` (new index -> old index). Stable ids travel with their
        particles (reference: ParticleData.cuh:492 sortParticles)."""
        perm = torch.as_tensor(perm, device=self.device).long()

        def take(a):
            if a is None or a.ndim == 0 or a.shape[0] != self.n:
                return a
            return a[perm]

        kw = {f.name: take(getattr(self, f.name)) for f in dataclasses.fields(self)
              if f.name not in ("gen", "extra", "time", "step")}
        kw["id"] = self.get_id()[perm]
        kw["extra"] = {k: take(v) for k, v in self.extra.items()}
        return self.replace(**kw)


def spatial_sort(state: SimState, box_size, n_cells: int = 64) -> SimState:
    """Sort particles by their cell on an ``n_cells``^3 grid, x fastest, for
    locality (reference: src/utils/ParticleSorter.cuh:51-129). A stable
    sort: particles of one cell keep their order."""
    Ls = torch.as_tensor(box_size, dtype=state.dtype, device=state.device).broadcast_to((3,))
    frac = state.pos / Ls + 0.5
    frac = frac - torch.floor(frac)
    c = torch.clamp((frac * n_cells).to(torch.int32), 0, n_cells - 1).long()
    h = (c[:, 2] * n_cells + c[:, 1]) * n_cells + c[:, 0]
    return state.permute(torch.argsort(h, stable=True))


def make_state(pos, *, seed: int = 0, vel=None, mass=None, radius=None, charge=None,
               type_id=None, dir=None, dtype=None, device=None) -> SimState:
    """A SimState from positions (numpy or tensors) on ``device`` (default
    the GPU, see ``resolve_device``)."""
    dtype = dtype or default_real
    dev = resolve_device(device)

    def cast(x, d=dtype):
        return None if x is None else torch.as_tensor(x, dtype=d, device=dev).clone()

    pos = cast(pos)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return SimState(
        pos=pos, gen=gen, vel=cast(vel), mass=cast(mass), radius=cast(radius),
        charge=cast(charge), dir=cast(dir), type_id=cast(type_id, torch.int32),
        id=torch.arange(pos.shape[0], dtype=torch.int32, device=dev),
        time=torch.zeros((), dtype=dtype, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def next_key(state: SimState) -> tuple:
    """The generator to draw this step's noise from: returns (state,
    generator). The JAX version splits the state's key; a generator
    advances as it is drawn from, so the state is returned unchanged."""
    return state, state.gen


_FIELDS = ("pos", "vel", "force", "mass", "radius", "charge", "energy", "virial",
           "torque", "ang_vel", "dir", "type_id", "id", "time", "step")


def sim_state_from_numpy(fields: dict, *, seed: int = 0, device=None) -> SimState:
    """A SimState from numpy arrays named as SimState's fields (missing or
    None fields stay None), with a generator seeded from ``seed``. Keeps
    each array's dtype, so a float64 JAX state stays float64."""
    dev = resolve_device(device)
    kw = {k: torch.as_tensor(np.asarray(v), device=dev)
          for k, v in fields.items() if k in _FIELDS and v is not None}
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return SimState(gen=gen, **kw)


def sim_state_to_numpy(state: SimState) -> dict:
    """The state's tensors as numpy arrays (the generator is left out)."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in _FIELDS if getattr(state, k) is not None}

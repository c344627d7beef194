"""Particle groups: subsets selected by rule, stable across reordering.

Port of ``uammd_tpu/core/groups.py`` (reference:
src/ParticleData/ParticleGroup.cuh:66-166, selectors All, None, IDRange,
Domain and Type). A group is a boolean mask over the particles; since ids
are stable, masks made from ids survive resorting. ``apply_masked``
restricts an integrator's update to a group.
"""

from __future__ import annotations

import torch

from .box import Box
from .state import SimState


def all_particles(state: SimState) -> torch.Tensor:
    return torch.ones(state.n, dtype=torch.bool, device=state.device)


def none(state: SimState) -> torch.Tensor:
    return torch.zeros(state.n, dtype=torch.bool, device=state.device)


def id_range(state: SimState, first: int, last: int) -> torch.Tensor:
    ids = state.get_id()
    return (ids >= first) & (ids <= last)


def id_list(state: SimState, ids) -> torch.Tensor:
    sel = none(state)
    sel[torch.as_tensor(ids, device=state.device).long()] = True
    return sel


def by_type(state: SimState, type_id: int) -> torch.Tensor:
    return state.get_type() == type_id


def domain(state: SimState, box: Box, lo, hi) -> torch.Tensor:
    """Particles inside an axis-aligned region (the Domain selector)."""
    p = box.wrap_position(state.pos)
    lo = torch.as_tensor(lo, dtype=p.dtype, device=p.device)
    hi = torch.as_tensor(hi, dtype=p.dtype, device=p.device)
    return torch.all((p >= lo) & (p <= hi), dim=-1)


def apply_masked(state_new: SimState, state_old: SimState, mask) -> SimState:
    """Keep the updates of the masked particles only (the reference's
    per-group Integrator semantics)."""
    m = mask[:, None]

    def pick(new, old):
        if new is None or old is None:
            return new
        if new.ndim == 2:
            return torch.where(m, new, old)
        if new.ndim == 1 and new.shape[0] == mask.shape[0]:
            return torch.where(mask, new, old)
        return new

    return state_new.replace(pos=pick(state_new.pos, state_old.pos),
                             vel=pick(state_new.vel, state_old.vel),
                             force=pick(state_new.force, state_old.force))

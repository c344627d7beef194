"""In-engine observables: per-particle energy, virial and stress.

Port of ``uammd_tpu/engine/observe.py`` (reference: src/Interactor/
Interactor.cuh:94-103, PairForces.cu:43-68): the pair-force kernel #1 with
its energy, virial and stress outputs on, so the pressure or energy of an
N = 2^20 state costs one extra kernel pass.

The state may come from any engine spec (the v2 engine's straggler list
included): it is repacked into a straggler-free spec whose CAP is the
largest occupancy of the host positions (one host read, off the hot path),
and the slot outputs go back to pid order by a scatter (JAX sorts).
"""

from __future__ import annotations

import torch

from .layout import choose_spec, pack, unpack
from .md import lj_e, lj_g
from .pair_kernel import make_pair_force_kernel


def observe_energy_virial_stress(gs, g_fn, e_fn):
    """Per-particle (energy [N], virial [N], stress [N, 6]) in pid order.

    ``g_fn`` / ``e_fn`` are the radial force and pair energy in the engine
    convention (g = (dE/dr)/r, e = pair energy): ``md.lj_g`` and
    ``md.lj_e`` on the card. Raises when the repack overflows."""
    spec = gs.spec
    pos, _, _ = unpack(gs)
    spec0 = choose_spec(spec.box_size, gs.n, spec.cutoff, skin=spec.skin,
                        pos=pos.cpu().numpy(), n_strag=0)
    kern = make_pair_force_kernel(spec0, g_fn, e_fn, compute_virial=True, compute_stress=True)
    g0 = pack(spec0, pos, device=gs.device)
    if bool(g0.overflow):
        raise RuntimeError("observable repack overflow: CAP undersized")
    outs = kern(g0.x, g0.y, g0.z)
    n = gs.n
    idx = torch.where(g0.pid >= 0, g0.pid, n).reshape(-1).long()
    vals = torch.stack([a.reshape(-1) for a in outs[3:11]], dim=-1)
    out = torch.zeros((n + 1, 8), dtype=vals.dtype, device=vals.device)
    out.index_put_((idx,), vals)
    return out[:n, 0], out[:n, 1], out[:n, 2:8]


def lj_pressure(gs, *, epsilon=1.0, sigma=1.0, temperature=None, md=None):
    """Instantaneous LJ pressure P = rho kT + sum_i virial_i / (3V) (the
    reference's test/MD EOS estimator) and the total potential energy.
    ``temperature`` defaults to the kinetic temperature of ``md`` (the
    engine that stepped ``gs``). Returns 0-d tensors (P, E)."""
    en, vir, _ = observe_energy_virial_stress(gs, lj_g(epsilon, sigma), lj_e(epsilon, sigma))
    Lx, Ly, Lz = gs.spec.box_size
    V = float(Lx * Ly * Lz)
    if temperature is None:
        if md is None:
            raise ValueError("need the temperature or the engine for the kinetic one")
        temperature = md.temperature_of(gs)
    P = gs.n / V * temperature + torch.sum(vir) / (3.0 * V)
    return P, torch.sum(en)

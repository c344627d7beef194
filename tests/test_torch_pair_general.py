"""The port's general pair path (uammd_tpu_torch.interactors.pair over
neighbors.pair_map and potentials.radial) against the JAX package's.

``pair_forces`` with force, energy, virial and stress on: LJ unshifted and
shifted, [2, 2] type tables with type ids, ``wca`` and ``tabulate``, over
the port's own list, over JAX's list carried across
(``neighbor_list_from_numpy``, which tests ``apply_pairs`` apart from the
binning), and over all pairs (the dense NBody path). Each output within
1e-10 of max|ref| in float64 and 1e-5 in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as j_box
from uammd_tpu.core.grid import grid_from_cutoff as j_grid_from_cutoff
from uammd_tpu.core.types import Computables as JComputables
from uammd_tpu.interactors.pair import pair_forces as j_pair_forces
from uammd_tpu.neighbors import neighbor_list as jnl
from uammd_tpu.potentials import radial as jr
from uammd_tpu.utils.lattices import lattice
from uammd_tpu_torch.core.box import box
from uammd_tpu_torch.core.types import Computables
from uammd_tpu_torch.interactors.pair import pair_forces
from uammd_tpu_torch.neighbors import neighbor_list as tnl
from uammd_tpu_torch.neighbors.pair_map import apply_pairs, apply_pairs_dense
from uammd_tpu_torch.potentials import radial as tr

DT = {"float32": (np.float32, jnp.float32, torch.float32, 1e-5),
      "float64": (np.float64, jnp.float64, torch.float64, 1e-10)}
ALL = dict(force=True, energy=True, virial=True, stress=True)
EPS = [[1.0, 0.7], [0.7, 1.3]]
SIG = [[1.0, 1.1], [1.1, 0.9]]
RC = [[2.5, 2.6], [2.6, 2.2]]
_j_rebuild = jax.jit(jnl._rebuild, static_argnums=tuple(range(2, 9)))
# the potential an argument (a pytree), so cases of one structure share a compile
_j_forces = jax.jit(lambda pot, p, nl, t: j_pair_forces(pot, p, nl, type_id=t,
                                                        computables=JComputables(**ALL)))


def j_build(pos, jb, cutoff, sm=1.2):
    """JAX's build_neighbor_list (neighbor_list.py:173-181), its rebuild jitted."""
    n = pos.shape[0]
    shape = j_grid_from_cutoff(jb, cutoff * sm)
    cap = max(4, int(np.ceil(n / (shape[0] * shape[1] * shape[2]) * 2.0)) + 4)
    k = jnl._auto_max_neighbors(n, float(jnp.prod(jb.size)), cutoff * sm)
    return _j_rebuild(jnp.asarray(pos), jb, cutoff, sm, shape, cap, k, 32768, False)


def _potentials(dt):
    _, jd, td, _ = DT[dt]
    out = {
        "lj": (jr.lj(cutoff=2.5, dtype=jd), tr.lj(cutoff=2.5, dtype=td, device="cpu")),
        "lj_shift": (jr.lj(epsilon=1.2, sigma=0.95, cutoff=2.2, shift=True, dtype=jd),
                     tr.lj(epsilon=1.2, sigma=0.95, cutoff=2.2, shift=True, dtype=td,
                           device="cpu")),
        "lj_types": (jr.lj(EPS, SIG, RC, shift=True, dtype=jd),
                     tr.lj(EPS, SIG, RC, shift=True, dtype=td, device="cpu")),
        "wca": (jr.wca(1.0, 1.3, dtype=jd), tr.wca(1.0, 1.3, dtype=td, device="cpu")),
    }
    base_j, base_t = out["lj"]
    out["tabulated"] = (jr.tabulate(base_j, 2.5, 2048, dtype=jd),
                        tr.tabulate(base_t, 2.5, 2048, dtype=td))
    return out


def _system(np_dt, n=864, rho=0.5, seed=0):
    L = (n / rho) ** (1.0 / 3.0)
    rng = np.random.default_rng(seed)
    pos = lattice(n, L, "fcc") + rng.uniform(-0.3, 0.3, (n, 3))
    types = rng.integers(0, 2, n).astype(np.int32)
    return (pos - L * np.round(pos / L)).astype(np_dt), types, L


def _cmp(got, want, tol):
    for k in ("force", "energy", "virial", "stress"):
        a = getattr(got, k).numpy()
        b = np.asarray(getattr(want, k))
        scale = np.abs(b).max()
        assert scale > 0, k
        assert np.abs(a - b).max() <= tol * scale, (k, np.abs(a - b).max() / scale)


@pytest.mark.parametrize("dt", sorted(DT))
@pytest.mark.parametrize("name", ["lj", "lj_shift", "lj_types", "wca", "tabulated"])
def test_pair_forces_list_and_dense_match_jax(name, dt):
    np_dt, jd, td, tol = DT[dt]
    pos, types, L = _system(np_dt)
    jpot, tpot = _potentials(dt)[name]
    assert tpot.max_cutoff == jpot.max_cutoff
    typed = name == "lj_types"
    jt = jnp.asarray(types) if typed else None
    tt = torch.as_tensor(types) if typed else None
    jb, tb = j_box(L, dtype=jd), box(L, dtype=td, device="cpu")
    jl = j_build(pos, jb, jpot.max_cutoff)
    want = _j_forces(jpot, jnp.asarray(pos), jl, jt)
    p = torch.as_tensor(pos)
    tl = tnl.build_neighbor_list(p, tb, tpot.max_cutoff)
    np.testing.assert_array_equal(tl.idx.numpy(), np.asarray(jl.idx))
    _cmp(pair_forces(tpot, p, tl, type_id=tt, computables=Computables(**ALL)), want, tol)
    carried = tnl.neighbor_list_from_numpy(
        {"idx": np.asarray(jl.idx), "ref_pos": np.asarray(jl.ref_pos),
         "overflow": bool(jl.overflow), "cutoff": jl.cutoff,
         "skin_multiplier": jl.skin_multiplier, "grid_shape": jl.grid_shape,
         "cell_capacity": jl.cell_capacity, "chunk": jl.chunk,
         "include_self": jl.include_self}, tb)
    _cmp(pair_forces(tpot, p, carried, type_id=tt, computables=Computables(**ALL)), want, tol)
    if name in ("lj_types", "tabulated"):
        dense = pair_forces(tpot, p, box=tb, type_id=tt, computables=Computables(**ALL))
        _cmp(dense, want, tol)


def test_virial_is_the_stress_trace_and_forces_sum_to_zero():
    pos, _, L = _system(np.float64)
    tb = box(L, dtype=torch.float64, device="cpu")
    p = torch.as_tensor(pos)
    pot = tr.lj(cutoff=2.5, dtype=torch.float64, device="cpu")
    out = pair_forces(pot, p, tnl.build_neighbor_list(p, tb, pot.max_cutoff),
                      computables=Computables(**ALL))
    s = out.stress
    torch.testing.assert_close(s[:, 0] + s[:, 3] + s[:, 5], out.virial, rtol=1e-12, atol=1e-12)
    assert float(out.force.sum(0).abs().max()) < 1e-10 * float(out.force.abs().max())
    with pytest.raises(ValueError):
        pair_forces(pot, p)


def test_apply_pairs_takes_tuple_info_and_dense_chunks():
    pos, types, L = _system(np.float64, n=500, seed=2)
    tb = box(L, dtype=torch.float64, device="cpu")
    p = torch.as_tensor(pos)
    q = torch.as_tensor(np.random.default_rng(1).normal(size=500))
    nl = tnl.build_neighbor_list(p, tb, 2.0, skin_multiplier=1.0)

    def kern(r2, dr, info_i, info_j, idx):
        qi, ti = info_i
        qj, tj = info_j
        w = torch.where(r2 < 4.0, qi * qj / r2, 0.0)
        return {"e": w, "n": torch.where(r2 < 4.0, (ti == tj).to(r2.dtype), 0.0)}

    info = (q, torch.as_tensor(types))
    a = apply_pairs(kern, nl, p, info)
    b = apply_pairs_dense(kern, p, tb, info, chunk=128)
    torch.testing.assert_close(a["e"], b["e"], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(a["n"], b["n"], rtol=0, atol=0)

"""The port's in-engine observables (uammd_tpu_torch.engine.observe) and the
pair kernel's energy/virial/stress outputs (#1) against the JAX package's
(Pallas interpret mode on the CPU).

- ``lj_e`` (plain and shifted) against JAX's ``md.lj_e``;
- ``observe_energy_virial_stress`` on tests/test_observe.py:53's system (n
  600, L 12, CAP 8 with a 128-row straggler list, so the repack gathers
  stragglers) against JAX's on the same state, within test_observe.py:67-73's
  tolerances; the stress trace equals the virial (test_observe.py:48);
- the kernel's outputs when only some are asked for equal the full set;
- ``lj_pressure`` of a dilute gas is rho kT (test_observe.py:80-99);
- ``gpu``: the CUDA observable mode against its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import layout as jl
from uammd_tpu.engine import md as jmd
from uammd_tpu.engine.observe import observe_energy_virial_stress as j_observe
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine import md as tmd
from uammd_tpu_torch.engine import pair_kernel as tp
from uammd_tpu_torch.engine.md2 import make_lj_md2
from uammd_tpu_torch.engine.observe import lj_pressure, observe_energy_virial_stress
from uammd_tpu_torch.utils.lattices import lattice

N, L = 600, 12.0


def _liquidish(seed=0, jitter=0.3):
    rng = np.random.default_rng(seed)
    pos = np.asarray(lattice(N, L, "fcc"))
    return (pos + jitter * rng.standard_normal(pos.shape)).astype(np.float32)


def test_lj_e_matches_jax():
    r2 = np.linspace(0.8, 7.0, 777, dtype=np.float32)
    for kw in ({}, {"epsilon": 0.7, "sigma": 1.3, "shift_rc": 2.5}):
        want = jax.jit(jmd.lj_e(**kw))(r2)
        got = tmd.lj_e(**kw)(torch.from_numpy(r2)).numpy()
        # float32 round-off (XLA contracts FMAs), relative to the largest
        # energy: the sum cancels where the energy crosses 0
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-6,
                                   atol=1e-7 * np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def observed():
    pos = _liquidish()
    spec = make_lj_md2(L, N, dt=0.004, temperature=0.0, cap=8, n_strag=128, pos=pos,
                       device="cpu").spec
    gt = tl.pack(spec, pos, device="cpu")
    assert int((gt.spid >= 0).sum()) > 0, "want stragglers"
    fields = tl.grid_state_to_numpy(gt)
    gj = jl.GridState(spec=jl.GridSpec(**{f: getattr(spec, f) for f in (
        "box_size", "shape", "cap", "fold", "cutoff", "skin", "n_strag")}), n=N,
        key=jax.random.key(0), **{k: jnp.asarray(fields[k]) for k in tl.STATE_FIELDS})
    want = j_observe(gj, jmd.lj_g(), jmd.lj_e(), interpret=True)
    got = observe_energy_virial_stress(gt, tmd.lj_g(), tmd.lj_e())
    return [a.numpy() for a in got], [np.asarray(a) for a in want]


def test_observables_match_jax(observed):
    (en, vir, st), (en_j, vir_j, st_j) = observed
    assert st.shape == (N, 6)
    np.testing.assert_allclose(en, en_j, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(vir, vir_j, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st, st_j, rtol=2e-4, atol=2e-4)


def test_stress_trace_is_virial(observed):
    (_, vir, st), _ = observed
    np.testing.assert_allclose(st[:, 0] + st[:, 3] + st[:, 5], vir, rtol=1e-5, atol=1e-8)


def test_output_subsets_equal_the_full_set():
    pos = _liquidish(seed=1)
    spec = tl.choose_spec(L, N, 2.5, pos=pos)
    gs = tl.pack(spec, pos, device="cpu")
    g, e = tmd.lj_g(), tmd.lj_e()
    full = tp.make_pair_force_kernel(spec, g, e, compute_virial=True, compute_stress=True)(
        gs.x, gs.y, gs.z)
    assert len(full) == 11
    ev = tp.make_pair_force_kernel(spec, g, e, compute_virial=True)(gs.x, gs.y, gs.z)
    st = tp.make_pair_force_kernel(spec, g, compute_stress=True)(gs.x, gs.y, gs.z)
    for a, b in zip(ev, full[:5]):
        assert torch.equal(a, b)
    for a, b in zip(st, full[:3] + full[5:]):
        assert torch.equal(a, b)


def test_lj_pressure_ideal_limit():
    n, Ld = 64, 40.0
    rng = np.random.default_rng(3)
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1)
    pos = ((g.reshape(-1, 3) + 0.5) * 10.0 - Ld / 2 + 0.1 * rng.random((64, 3)))
    md = make_lj_md2(Ld, n, dt=0.004, temperature=1.0, pos=pos, n_strag=0, device="cpu")
    gs = md.init(pos, seed=0)
    P, E = lj_pressure(gs, temperature=1.0)
    np.testing.assert_allclose(float(P), n / Ld ** 3, rtol=1e-3)
    assert abs(float(E)) < 1e-4
    P_md, _ = lj_pressure(gs, md=md)
    assert float(P_md) == pytest.approx(n / Ld ** 3 * float(md.temperature_of(gs)), rel=1e-3)
    with pytest.raises(ValueError):
        lj_pressure(gs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_observable_mode_matches_plain(cuda):
    pos = _liquidish()
    spec = tl.choose_spec(L, N, 2.5, pos=pos)
    gs = tl.pack(spec, pos, device="cpu")
    kern = tp.make_pair_force_kernel(spec, tmd.lj_g(), tmd.lj_e(), compute_virial=True,
                                     compute_stress=True)
    want = kern(gs.x, gs.y, gs.z)
    before = tp.PAIR_FORCE_OBS.launches
    got = kern(*(a.to(cuda) for a in (gs.x, gs.y, gs.z)))
    torch.cuda.synchronize()
    assert tp.PAIR_FORCE_OBS.launches == before + 1
    m = gs.mask
    for a, b in zip(got, want):
        scale = float(b[m].abs().max())
        assert float((a.cpu()[m] - b[m]).abs().max()) <= 2e-5 * scale

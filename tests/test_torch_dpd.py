"""The port's DPD engine (uammd_tpu_torch.engine.dpd) against the JAX
package's (the channel kernel #2 in Pallas interpret mode on the CPU).

- the pair-noise hash (``_mix``, ``_hash``, ``_u24f``) bit-equal to JAX's on
  random int32 words;
- the forces of tests/test_engine_dpd.py:18's system (n 320, L 8, CAP 8)
  at T = 0 and at T > 0 with the step counter at 7 (both sides hash the
  same integers), within 1e-5 of max|f| (test_engine_dpd.py:45's bar):
  float32 sums in another order; both sides get the port's packed slots;
- momentum conserved over 5 port steps (test_engine_dpd.py:57-70);
- ``gpu``: the CUDA functor against its plain version, one launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import dpd as jd
from uammd_tpu.engine import layout as jl
from uammd_tpu_torch.engine import dpd as td
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine import pair_kernel as tp
from uammd_tpu_torch.utils.lattices import lattice

N, L = 320, 8.0
KW = dict(rc=1.0, A=25.0, gamma=4.5, dt=0.01)
STEP = 7
TOL = 1e-5


def _jit0(fn, *args):
    """jax.jit(fn) compiled for ``args`` at backend optimisation level 0."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    pos = np.asarray(lattice(N, L, "fcc"))
    pos = pos + 0.05 * rng.standard_normal(pos.shape)
    return pos.astype(np.float32), rng.standard_normal((N, 3)).astype(np.float32)


def _as_int32(h):
    """uint32 values held in int64 -> the int32 bit pattern JAX holds."""
    return (h - ((h >> 31) << 32)).to(torch.int32)


def test_hash_matches_jax_bit_for_bit():
    rng = np.random.default_rng(4)
    a, b, c = (rng.integers(-2**31, 2**31, size=4096, dtype=np.int64).astype(np.int32)
               for _ in range(3))
    want2, want3, wantu = jax.jit(lambda a, b, c: (
        jd._hash(a, b), jd._hash(a, b, c), jd._u24f(jd._hash(c, a))))(a, b, c)
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))
    got2 = _as_int32(td._hash(ta, tb))
    got3 = _as_int32(td._hash(ta, tb, tc))
    gotu = td._u24f(td._hash(tc, ta))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
    np.testing.assert_array_equal(got3.numpy(), np.asarray(want3))
    np.testing.assert_array_equal(gotu.numpy(), np.asarray(wantu))
    # the pair functor's constants words
    np.testing.assert_array_equal(
        _as_int32(td._hash(ta, 5, td._K1)).numpy(),
        np.asarray(jax.jit(lambda a: jd._hash(a, np.int32(5), np.int32(0x00BEEF01)))(a)))


def _forces(temperature):
    """(port forces, JAX forces, mask) at the step counter STEP."""
    pos, vel = _setup()
    md_t = td.GridDPD.create(L, N, temperature=temperature, device="cpu", **KW)
    md_j = jd.GridDPD.create(L, N, temperature=temperature, interpret=True, **KW)
    assert md_t.spec == tl.GridSpec(**{f: getattr(md_j.spec, f) for f in (
        "box_size", "shape", "cap", "fold", "cutoff", "skin", "n_strag")})
    gt = tl.pack(md_t.spec, pos, vel=vel, device="cpu")
    gt = gt.replace(step=torch.tensor(STEP, dtype=torch.int32))
    f_t = md_t.compute_forces(gt, gt.vx, gt.vy, gt.vz)
    fields = tl.grid_state_to_numpy(gt)
    gj = jl.GridState(spec=md_j.spec, n=N, key=jax.random.key(0),
                      **{k: jnp.asarray(fields[k]) for k in tl.STATE_FIELDS})
    f_j = _jit0(lambda g: md_j.compute_forces(g, g.vx, g.vy, g.vz), gj)(gj)
    return [a.numpy() for a in f_t], [np.asarray(a) for a in f_j], gt.mask.numpy()


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_forces_match_jax(temperature):
    f_t, f_j, m = _forces(temperature)
    scale = max(np.abs(a[m]).max() for a in f_j)
    err = max(np.abs(a[m] - b[m]).max() for a, b in zip(f_t, f_j))
    assert err / scale < TOL, err / scale
    for a in f_t:
        assert np.all(a[~m] == 0.0)


def test_momentum_conserved_with_noise():
    pos, vel = _setup(seed=1)
    vel = vel - vel.mean(axis=0, keepdims=True)
    md = td.GridDPD.create(L, N, rc=1.0, A=10.0, gamma=4.5, temperature=1.0, dt=0.01,
                           device="cpu")
    gs = md.run(md.init(pos, vel=vel), 5)
    assert not bool(gs.overflow)
    assert int(gs.step) == 5
    for comp in (gs.vx, gs.vy, gs.vz):
        assert abs(float(comp.sum())) < 5e-3


def test_init_draws_maxwellian_and_rejects_stragglers():
    pos, _ = _setup(seed=2)
    md = td.GridDPD.create(L, N, temperature=1.0, device="cpu", **KW)
    gs = md.init(pos, seed=3)
    assert abs(float(md.temperature_of(gs)) - 1.0) < 0.2
    assert bool((gs.vx[~gs.mask] == 0).all())
    spec = tl.choose_spec(L, N, 1.0, cap=8, n_strag=16)
    with pytest.raises(ValueError, match="straggler"):
        tp.make_pair_channel_kernel(spec, td.DPDPair(1.0, 25.0, 4.5, 1.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_dpd_functor_matches_plain(cuda):
    pos, vel = _setup()
    md = td.GridDPD.create(L, N, temperature=1.0, device=cuda, **KW)
    gs = tl.pack(md.spec, pos, vel=vel, device=cuda).replace(
        step=torch.tensor(STEP, dtype=torch.int32, device=cuda))
    before = tp.PAIR_CHANNEL_DPD.launches
    got = md.compute_forces(gs, gs.vx, gs.vy, gs.vz)
    torch.cuda.synchronize()
    assert tp.PAIR_CHANNEL_DPD.launches == before + 1
    cpu = tl.grid_state_from_numpy(md.spec, tl.grid_state_to_numpy(gs), device="cpu")
    want = md.kern(cpu.x, cpu.y, cpu.z, cpu.vx, cpu.vy, cpu.vz, cpu.pid.float(),
                   cpu.step.float())
    scale = max(float(a.abs().max()) for a in want)
    assert max(float((a.cpu() - b).abs().max()) for a, b in zip(got, want)) < 2e-5 * scale

"""The drift that the G-J updates #11 and #12 return, against JAX's rule.

JAX takes it as ``jnp.max(mask * jnp.maximum(|x' - rx|, ...))``
(``gj_update_jnp``, update_kernel.py:354); under ``jax.jit`` XLA turns
``mask * y`` into ``select(mask, y, 0)``. So a NaN on an occupied slot
makes the drift NaN, and an empty slot adds exactly 0 whatever it holds.
The port's rule is that select, with NaN-keeping maxima.

- On three states with a non-finite value, and a finite one, the plain
  versions of #11 (``gj_update_z``, ``gj_update_plain``) and #12
  (``gj_fold_update_plain`` with zero reaction groups, both noises) return
  jitted ``gj_update_jnp``'s drift at T = 0: 0.9, NaN, 0.9 and 0.9.
- The straggler-drift option of #11 (``sref``) equals JAX's DD2 expression
  ``maximum(dinf, max(where(spidf > 0.5, |spos' - sref|, 0)))``
  (domain2.py:409-413), with the rows' ids as int32 pids or float32 pid + 1.
- The new entries refuse what their kernels cannot take before any launch.
- On a GPU the CUDA kernels return the plain drift on every state, NaN
  where it is NaN.

JAX runs only under ``jax.jit`` on [4, 3, 8, 12] grids: a few seconds. It
is imported by the tests that compare with it, so that on a machine with a
GPU and no JAX the CUDA cases run and those skip.
"""

import numpy as np
import pytest
import torch

from uammd_tpu_torch.engine import _build
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine import rebin_kernel as trk
from uammd_tpu_torch.engine import update_kernel as tu

DT, FRICTION, MASS = 0.01, 1.0, 1.0
SPEC = tl.GridSpec(box_size=(12.0, 12.0, 12.0), shape=(3, 12, 4), cap=8, fold=4,
                   cutoff=2.5, skin=1.2, n_strag=16)  # [4, 3, 8, 12]
SLOT = (0, 0, 0, 0)  # occupied, 0.9 past its reference on x
BAD = (1, 2, 3, 4)  # where a state puts its non-finite value
STATES = ("finite", "nan_position", "nan_force_occupied", "nan_velocity_empty")
WANT = {"finite": 0.9, "nan_position": 0.9, "nan_force_occupied": None,
        "nan_velocity_empty": 0.9}  # None: NaN


def grids(state: str, seed: int = 0):
    """(x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz) as float32 numpy: half
    the slots occupied at small w and f, the references up to 0.05 away,
    slot SLOT at w = f = 0 and 0.9 from its reference, and the state's
    non-finite value at slot BAD."""
    rng = np.random.default_rng(seed)
    shape = SPEC.array_shape
    occ = rng.random(shape) < 0.5
    occ[SLOT] = True
    occ[BAD] = state != "nan_velocity_empty"
    pos = [np.where(occ, rng.uniform(-5.0, 5.0, shape), 1.0e9) for _ in range(3)]
    w = [np.where(occ, 0.1 * rng.standard_normal(shape), 0.0) for _ in range(3)]
    f = [np.where(occ, rng.standard_normal(shape), 0.0) for _ in range(3)]
    for a in w + f:
        a[SLOT] = 0.0
    ref = [p - np.where(occ, rng.uniform(-0.05, 0.05, shape), 0.0) for p in pos]
    ref[0][SLOT] = pos[0][SLOT] - 0.9
    if state == "nan_position":
        pos[0][BAD] = np.nan  # not < 1e8: the slot counts as empty
    elif state == "nan_force_occupied":
        f[1][BAD] = np.nan
    elif state == "nan_velocity_empty":
        w[2][BAD] = np.nan
    return [a.astype(np.float32) for a in pos + w + f + ref]


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def jax_drift(jax):
    from uammd_tpu.engine.update_kernel import gj_update_jnp

    jnp = jax.numpy
    fn = jax.jit(lambda *a: gj_update_jnp(SPEC, DT, 0.0, FRICTION, MASS, *a,
                                          jax.random.key(0))[1])
    return {s: float(fn(*(jnp.asarray(a) for a in grids(s)))) for s in STATES}


def same(a: float, b: float) -> bool:
    return (np.isnan(a) and np.isnan(b)) or a == b


@pytest.mark.parametrize("state", STATES)
def test_plain_drifts_follow_jax(jax_drift, state):
    want = jax_drift[state]
    assert same(want, np.nan if WANT[state] is None else np.float32(0.9))
    t = [torch.from_numpy(a) for a in grids(state)]
    coef = tu.GJCoefficients(DT, 0.0, FRICTION, MASS)
    zero = torch.zeros_like(t[0])
    seed = torch.tensor(3, dtype=torch.int32)
    got = {"gj_update_z": tu.gj_update_z(coef, *t, zero, zero, zero)[1],
           "gj_update_plain": tu.gj_update_plain(SPEC, coef, *t, seed)[1]}
    for noise in tu.NOISES:
        got[f"gj_fold_update_plain {noise}"] = tu.gj_fold_update_plain(
            SPEC, coef, noise, *t[:9], [zero] * 12, *t[9:], seed)[1]
    for name, d in got.items():
        assert same(float(d), want), (name, float(d), want)


def strag_rows(kind: str, seed: int = 1):
    """(spos, svel, sforce, spidf, sref) of S rows as float32 numpy: 10
    occupied (pid + 1 > 0), row 2 moved 1.3 from its reference, and per
    ``kind`` a NaN position on an occupied row or on an empty one."""
    rng = np.random.default_rng(seed)
    S = SPEC.n_strag
    occ = np.arange(S) < 10
    spos = np.where(occ[:, None], rng.uniform(-5.0, 5.0, (S, 3)), 1.0e9)
    svel = np.where(occ[:, None], 0.1 * rng.standard_normal((S, 3)), 0.0)
    sforce = np.where(occ[:, None], rng.standard_normal((S, 3)), 0.0)
    sref = spos - np.where(occ[:, None], rng.uniform(-0.05, 0.05, (S, 3)), 0.0)
    sref[2, 1] = spos[2, 1] + 1.3
    spidf = np.where(occ, np.arange(S) + 101.0, 0.0)
    if kind == "nan_occupied":
        spos[4, 2] = np.nan
    elif kind == "nan_empty":
        spos[12, 0] = np.nan
    return [a.astype(np.float32) for a in (spos, svel, sforce, spidf, sref)]


@pytest.mark.parametrize("kind", ["finite", "nan_occupied", "nan_empty"])
@pytest.mark.parametrize("ids", ["pid_int32", "pidf_float32"])
def test_straggler_drift_follows_jax_domain2(jax, jax_drift, kind, ids):
    jnp = jax.numpy
    t = [torch.from_numpy(a) for a in grids("finite")]
    spos, svel, sforce, spidf, sref = (torch.from_numpy(a) for a in strag_rows(kind))
    spid = spidf if ids == "pidf_float32" else (spidf.to(torch.int32) - 1)
    coef = tu.GJCoefficients(DT, 0.0, FRICTION, MASS)
    seed = torch.tensor(3, dtype=torch.int32)
    grid_only = tu.gj_update_plain(SPEC, coef, *t, seed, (spos, svel, sforce, spid))
    got = tu.gj_update_plain(SPEC, coef, *t, seed, (spos, svel, sforce, spid), sref)
    assert all(torch.equal(a.nan_to_num(), b.nan_to_num())
               for a, b in zip(got[0] + got[2], grid_only[0] + grid_only[2]))

    @jax.jit
    def jax_side(dinf, spos2, spidf, sref):
        sm = (spidf > 0.5)[:, None]
        return jnp.maximum(dinf, jnp.max(jnp.where(sm, jnp.abs(spos2 - sref), 0.0)))

    want = float(jax_side(jnp.float32(jax_drift["finite"]), jnp.asarray(got[2][0].numpy()),
                          jnp.asarray(spidf.numpy()), jnp.asarray(sref.numpy())))
    assert same(float(got[1]), want)
    if kind == "nan_occupied":
        assert np.isnan(want)
    else:
        assert abs(want - 1.3) < 0.05  # row 2's move, not the grid's 0.9
    # the int32 and the float32 ids mark the same rows
    other = spidf.to(torch.int32) - 1 if ids == "pidf_float32" else spidf
    again = tu.gj_update_plain(SPEC, coef, *t, seed, (spos, svel, sforce, other), sref)
    assert all(torch.equal(a.nan_to_num(), b.nan_to_num()) for a, b in zip(again[2], got[2]))
    assert same(float(again[1]), float(got[1]))


def test_new_entries_refuse_wrong_inputs_before_any_launch(monkeypatch):
    """#11: ``sref`` without the straggler rows, a wrong shape on the CPU;
    on tensors that are not on the CPU (meta here) the CUDA route, which
    raises on a tensor that is not a CUDA one (grids, straggler rows,
    references) and on a plane that 16-byte loads cannot cover. #4: a Q the
    kernel has no instance for, a grid of fewer than 3 cells an axis."""
    shape = SPEC.array_shape
    upd = tu.make_gj_update_kernel(SPEC, DT, 1.0, FRICTION, MASS)
    seed = torch.tensor(1, dtype=torch.int32)
    g = [torch.zeros(shape) for _ in range(12)]
    with pytest.raises(ValueError, match="sref"):
        upd(*g, seed, None, torch.zeros((16, 3)))
    with pytest.raises(ValueError):
        upd(*g[:11], torch.zeros((4, 3, 8, 8)), seed)
    meta = {"device": "meta"}
    n0, r0 = tu.GJ_UPDATE.launches, trk.REBIN2.launches
    gm = [torch.empty(shape, **meta) for _ in range(12)]
    sm = tuple(torch.empty((16, 3), **meta) for _ in range(3)) + (torch.empty(16, **meta),)
    seed_m = torch.empty((), dtype=torch.int32, **meta)
    for args in ((*gm, seed_m), (*gm, seed_m, sm), (*gm, seed_m, sm, torch.empty((16, 3), **meta))):
        with pytest.raises(ValueError, match="CUDA"):
            upd(*args)
    # every input is checked before the launch's first step (the scratch,
    # which needs the built library: nvcc, absent here)
    checked = []
    monkeypatch.setattr(_build, "check_cuda_tensors",
                        lambda ts, name, *a, **k: checked.append(name))
    monkeypatch.setattr(_build, "check_cuda_tensor",
                        lambda t, name, *a, **k: checked.append(name))
    monkeypatch.setattr(tu, "gj_update_scratch",
                        lambda *a: pytest.fail("scratch before the checks"))
    spid64 = torch.empty(16, dtype=torch.int64, **meta)
    with pytest.raises(BaseException):
        upd(*gm, seed_m, sm[:3] + (spid64,), torch.empty((16, 3), **meta))
    assert checked == ["update grid", "seed", "straggler input", "spid", "sref"]
    odd = tl.GridSpec(box_size=(12.0, 12.0, 12.0), shape=(3, 4, 4), cap=3, fold=1,
                      cutoff=2.5, skin=1.2, n_strag=0)
    with pytest.raises(ValueError, match="multiple of 4"):
        tu.make_gj_update_kernel(odd, DT, 1.0, FRICTION, MASS)(
            *(torch.empty(odd.array_shape, **meta) for _ in range(12)), seed_m)
    r2 = trk.make_rebin_kernel2(SPEC)
    with pytest.raises(ValueError, match="Q = 7 or 4"):
        r2(torch.empty((5,) + shape, **meta), torch.empty((5, 16), **meta))
    thin = tl.GridSpec(box_size=(12.0, 12.0, 12.0), shape=(3, 8, 2), cap=8, fold=2,
                       cutoff=2.5, skin=1.2, n_strag=16)
    with pytest.raises(ValueError, match="3 cells"):
        trk.make_rebin_kernel2(thin)(torch.empty((7,) + thin.array_shape, **meta),
                                     torch.empty((7, 16), **meta))
    assert (tu.GJ_UPDATE.launches, trk.REBIN2.launches) == (n0, r0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def on(x, dev):
    """``x`` (a tensor, a tuple of them or None) on ``dev``."""
    if x is None:
        return None
    return tuple(a.to(dev) for a in x) if isinstance(x, tuple) else x.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("state", STATES)
def test_cuda_drifts_equal_plain(cuda, state):
    t = [torch.from_numpy(a) for a in grids(state)]
    spos, svel, sforce, spidf, sref = (torch.from_numpy(a) for a in strag_rows("nan_empty"))
    seed = torch.tensor(3, dtype=torch.int32)
    for temperature in (0.0, 1.0):
        upd = tu.make_gj_update_kernel(SPEC, DT, temperature, FRICTION, MASS)
        for strag, ref in ((None, None), ((spos, svel, sforce, spidf), sref)):
            want = upd(*t, seed, strag, ref)
            got = upd(*on(tuple(t), cuda), seed.to(cuda), on(strag, cuda), on(ref, cuda))
            g, w = float(got[1]), float(want[1])
            # "bm" at T > 0: the card's logf/sinf/cosf, a few ulps off
            assert same(g, w) or (temperature > 0 and abs(g - w) <= 1e-5), (temperature, g, w)
        fused = tu.make_gj_fold_update_kernel(SPEC, DT, temperature, FRICTION, MASS, noise="clt")
        forces = torch.cat([torch.stack(t[6:9]), torch.zeros((12,) + SPEC.array_shape)])
        want = fused.stacked(*t[:6], forces, *t[9:], seed)
        got = fused.stacked(*on(tuple(t[:6]), cuda), forces.to(cuda), *on(tuple(t[9:]), cuda),
                            seed.to(cuda))
        assert same(float(got[1]), float(want[1])), (temperature, float(got[1]))

"""The port's grid layout (uammd_tpu_torch.engine.layout) against the JAX
package's: identical geometry choice, identical slots after pack and after
the sort rebin, and a state carry between the two.

Also holds the port's import boundary: uammd_tpu_torch imports neither jax
nor the JAX package, and its entry points default to the GPU.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import layout as jl
from uammd_tpu.utils.lattices import lattice as j_lattice
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.utils.lattices import lattice as t_lattice

REPO = pathlib.Path(__file__).resolve().parents[1]


def _fields(gs):
    """A JAX GridState's array fields as numpy, in the carry's format."""
    out = {k: np.asarray(getattr(gs, k)) for k in tl.STATE_FIELDS}
    out["n"] = gs.n
    return out


def _assert_states_equal(gj, gt):
    for k in tl.STATE_FIELDS:
        a = np.asarray(getattr(gj, k))
        b = getattr(gt, k).numpy()
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("n,L,kind", [
    (1 << 20, 128.0, "fcc"), (1500, 24.0, "bcc"), (1000, 20.0, "sc"),
    (777, 13.3, "dia"), (300, 10.0, "tri"),
])
def test_lattice_equal(n, L, kind):
    np.testing.assert_array_equal(t_lattice(n, L, kind), j_lattice(n, L, kind))


def _random(n, L, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)) - 0.5) * np.asarray(L)


CHOOSE_CASES = {
    "poisson_1500": dict(box_size=24.0, n=1500, cutoff=2.5),
    "poisson_fold4": dict(box_size=36.0, n=2000, cutoff=2.5),
    "occupancy": dict(box_size=24.0, n=1500, cutoff=2.5, pos=_random(1500, 24.0, 1)),
    "strag": dict(box_size=(20.0, 30.0, 40.0), n=3000, cutoff=2.5,
                  pos=_random(3000, (20.0, 30.0, 40.0), 2), n_strag=16),
    "lanes64": dict(box_size=30.0, n=1200, cutoff=2.0, skin=1.1, max_lanes=64),
    # CAP 16 against the defaults' 8: the per-cell excess limit binds
    "strag_excess": dict(box_size=(20.0, 30.0, 40.0), n=3000, cutoff=2.5,
                         pos=_random(3000, (20.0, 30.0, 40.0), 2), n_strag=128,
                         strag_cell_excess=2),
    # CAP 8 against the defaults' 16: the smaller headroom admits it
    "strag_headroom": dict(box_size=(20.0, 30.0, 40.0), n=3000, cutoff=2.5,
                           pos=_random(3000, (20.0, 30.0, 40.0), 2), n_strag=32,
                           strag_cell_excess=3, strag_headroom=1.0),
}


@pytest.mark.parametrize("case", sorted(CHOOSE_CASES))
def test_choose_spec_equal(case):
    kw = CHOOSE_CASES[case]
    a = jl.choose_spec(**kw)
    b = tl.choose_spec(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.array_shape == b.array_shape
    assert a.drift_threshold == b.drift_threshold


def test_choose_spec_rejects_excess_over_mini_grid():
    """More stragglers per cell than the separable rebin's mini-grid holds."""
    kw = dict(box_size=20.0, n=1000, cutoff=2.5, pos=_random(1000, 20.0, 3))
    with pytest.raises(ValueError, match="mini-grid"):
        tl.choose_spec(**kw, n_strag=16, strag_cell_excess=tl.OCAP + 1)
    tl.choose_spec(**kw, n_strag=16, strag_cell_excess=tl.OCAP)
    tl.choose_spec(**kw, strag_cell_excess=tl.OCAP + 1)  # no straggler list


def test_choose_spec_benchmark_size():
    """The 2^20 fcc benchmark spec, checked on the JAX package."""
    pos = t_lattice(1 << 20, 128.0, "fcc")
    b = tl.choose_spec(128.0, 1 << 20, 2.5, pos=pos)
    assert dataclasses.asdict(b) == dataclasses.asdict(
        jl.choose_spec(128.0, 1 << 20, 2.5, pos=pos))
    assert (b.shape, b.cap, b.fold) == ((32, 40, 42), 40, 4)
    assert b.array_shape == (42, 10, 40, 128)
    assert b.n_slots == 2_150_400
    assert abs(b.drift_threshold - 0.27381) < 1e-5


@pytest.fixture(scope="module")
def system():
    n, L = 1500, 24.0
    rng = np.random.default_rng(2)
    pos = (rng.random((n, 3)) - 0.5) * L
    vel = rng.standard_normal((n, 3))
    force = rng.standard_normal((n, 3))
    spec_j = jl.choose_spec(L, n, 2.5)
    spec_t = tl.choose_spec(L, n, 2.5)
    return n, L, pos, vel, force, spec_j, spec_t


@pytest.mark.parametrize("strag", [0, 32], ids=["plain", "strag"])
def test_pack_matches_jax_slot_for_slot(system, strag):
    n, L, pos, vel, force, spec_j, spec_t = system
    if strag:
        # CAP below the max occupancy: the tail goes to the side list
        spec_j = dataclasses.replace(spec_j, cap=8, n_strag=strag)
        spec_t = dataclasses.replace(spec_t, cap=8, n_strag=strag)
    gj = jl.pack(spec_j, pos, vel=vel, force=force)
    gt = tl.pack(spec_t, pos, vel=vel, force=force, device="cpu")
    _assert_states_equal(gj, gt)
    if strag:
        assert int((gt.spid >= 0).sum()) > 0


def test_pack_unpack_roundtrip(system):
    n, L, pos, vel, force, spec_j, spec_t = system
    gt = tl.pack(spec_t, pos, vel=vel, force=force, device="cpu")
    p, v, f = (a.numpy() for a in tl.unpack(gt))
    pw = pos - L * np.round(pos / L)
    np.testing.assert_allclose(p, pw, atol=1e-5)
    np.testing.assert_array_equal(v, vel.astype(np.float32))
    np.testing.assert_array_equal(f, force.astype(np.float32))
    for a, b in zip(jl.unpack(jl.pack(spec_j, pos, vel=vel, force=force)),
                    (p, v, f)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("strag", [0, 32], ids=["plain", "strag"])
def test_sort_rebin_matches_jax(system, strag):
    n, L, pos, vel, force, spec_j, spec_t = system
    if strag:
        spec_j = dataclasses.replace(spec_j, cap=8, n_strag=strag)
        spec_t = dataclasses.replace(spec_t, cap=8, n_strag=strag)
    gj = jl.pack(spec_j, pos, vel=vel, force=force)
    f = _fields(gj)
    rng = np.random.default_rng(3)
    m = f["pid"] >= 0
    for k in ("x", "y", "z"):
        f[k] = (f[k] + 0.8 * rng.standard_normal(f[k].shape) * m).astype(np.float32)
    gj = gj.replace(**{k: jnp.asarray(f[k]) for k in ("x", "y", "z")})
    gt = tl.grid_state_from_numpy(spec_t, f, device="cpu")
    assert bool(tl.needs_rebin(gt)) == bool(jl.needs_rebin(gj))
    rj, rt = jl.rebin(gj), tl.rebin(gt)
    _assert_states_equal(rj, rt)
    assert int((rt.pid >= 0).sum()) + int((rt.spid >= 0).sum()) == n
    assert not bool(tl.needs_rebin(rt))


def test_state_carry_roundtrip(system):
    n, L, pos, vel, force, spec_j, spec_t = system
    f = _fields(jl.pack(spec_j, pos, vel=vel, force=force))
    gt = tl.grid_state_from_numpy(spec_t, f, device="cpu", seed=3)
    back = tl.grid_state_to_numpy(gt)
    assert back["n"] == n
    for k in tl.STATE_FIELDS:
        assert back[k].dtype == f[k].dtype, k
        np.testing.assert_array_equal(back[k], f[k], err_msg=k)


def test_state_carry_keeps_reaction_groups(system):
    n, L, pos, vel, force, spec_j, spec_t = system
    f = _fields(jl.pack(spec_j, pos, vel=vel, force=force))
    f["fgrp"] = tuple(np.full(spec_t.array_shape, k, np.float32) for k in range(12))
    gt = tl.grid_state_from_numpy(spec_t, f, device="cpu")
    assert len(gt.fgrp) == 12 and all(float(g[0, 0, 0, 0]) == k for k, g in enumerate(gt.fgrp))
    back = tl.grid_state_to_numpy(gt)
    for a, b in zip(back["fgrp"], f["fgrp"]):
        np.testing.assert_array_equal(a, b)
    assert tl.grid_state_to_numpy(tl.pack(spec_t, pos, device="cpu"))["fgrp"] == ()


def test_entry_points_default_to_gpu(system):
    n, L, pos, vel, force, spec_j, spec_t = system
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.pack(spec_t, pos)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.grid_state_from_numpy(spec_t, _fields(jl.pack(spec_j, pos)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import uammd_tpu_torch, uammd_tpu_torch.engine.md, uammd_tpu_torch.engine.md2\n"
        "import uammd_tpu_torch.utils.lattices\n"
        "import uammd_tpu_torch.integrators.bdhi.euler_maruyama\n"
        "import uammd_tpu_torch.interactors.external\n"
        "import uammd_tpu_torch.integrators.bdhi.pse_engine, uammd_tpu_torch.engine.pse_near\n"
        "import uammd_tpu_torch.solvers.lanczos, uammd_tpu_torch.integrators.bdhi.pse\n"
        "import uammd_tpu_torch.engine.dpd, uammd_tpu_torch.engine.sph\n"
        "import uammd_tpu_torch.engine.mixtures, uammd_tpu_torch.engine.observe\n"
        "import uammd_tpu_torch.interactors.sph\n"
        "import uammd_tpu_torch.electrostatics.poisson, uammd_tpu_torch.integrators.brownian\n"
        "import uammd_tpu_torch.engine.rebin_kernel, uammd_tpu_torch.engine.update_kernel\n"
        "import uammd_tpu_torch.parallel.mesh, uammd_tpu_torch.parallel.domain\n"
        "import uammd_tpu_torch.parallel.domain2\n"
        "import uammd_tpu_torch.neighbors.pair_map, uammd_tpu_torch.potentials.dpd\n"
        "import uammd_tpu_torch.interactors.pair, uammd_tpu_torch.interactors.bonded\n"
        "import uammd_tpu_torch.integrators.verlet, uammd_tpu_torch.core.groups\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'uammd_tpu' or m.startswith('uammd_tpu.')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    sources = [p for p in (REPO / "uammd_tpu_torch").rglob("*")
               if p.suffix in (".py", ".cu", ".cuh")]
    assert len(sources) >= 8
    for p in sources:
        text = p.read_text()
        for needle in ("uammd_tpu.", "import jax", "from jax"):
            assert needle not in text, (p, needle)

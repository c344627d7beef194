"""The port's rebin kernel (uammd_tpu_torch.engine.rebin_kernel) against the
JAX package's Pallas kernel (interpret mode on the CPU): equal slot for
slot, exactly, for Q = 7 (rebin_fast_noforce, the MD path) and Q = 10
(rebin_fast), and a capacity violation latches overflow.

The JAX kernel runs once, with Q = 10: its placement does not depend on the
payload, so its positions, velocities and pids are also the reference for
Q = 7 (whose forces come back zero). It runs under ``jax.jit``: one
compile of the interpret-mode kernel takes about 45 s on one CPU core,
and an eager call pays about as much again every time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import layout as jl
from uammd_tpu.engine.rebin_kernel import rebin_fast as j_rebin_fast
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine.rebin_kernel import (
    REBIN,
    make_rebin_kernel,
    rebin_fast,
    rebin_fast_noforce,
)

PORT = {7: rebin_fast_noforce, 10: rebin_fast}


@pytest.fixture(scope="module")
def displaced():
    """The n 1500, L 24 system (NLANE 16, fold 2) with random velocities and
    forces, every particle displaced by less than the drift threshold."""
    n, L = 1500, 24.0
    rng = np.random.default_rng(2)
    pos = (rng.random((n, 3)) - 0.5) * L
    spec_j = jl.choose_spec(L, n, 2.5)
    spec_t = tl.choose_spec(L, n, 2.5)
    gj = jl.pack(spec_j, pos, vel=rng.standard_normal((n, 3)),
                 force=rng.standard_normal((n, 3)))
    f = {k: np.asarray(getattr(gj, k)) for k in tl.STATE_FIELDS}
    f["n"] = n
    m = f["pid"] >= 0
    step = 0.99 * spec_t.drift_threshold / np.sqrt(3.0)
    for k in ("x", "y", "z"):
        f[k] = (f[k] + rng.uniform(-step, step, f[k].shape) * m).astype(np.float32)
    gj = gj.replace(**{k: jnp.asarray(f[k]) for k in ("x", "y", "z")})
    return gj, tl.grid_state_from_numpy(spec_t, f, device="cpu")


@pytest.fixture(scope="module")
def jax_rebinned(displaced):
    return jax.jit(j_rebin_fast)(displaced[0])


@pytest.mark.parametrize("q", sorted(PORT))
def test_plain_matches_jax_kernel_exactly(displaced, jax_rebinned, q):
    _, gt = displaced
    launches = REBIN.launches
    rt = PORT[q](gt)
    assert REBIN.launches == launches  # the CPU path launches nothing
    for k in tl.STATE_FIELDS:
        want = np.asarray(getattr(jax_rebinned, k))
        if q == 7 and k in ("fx", "fy", "fz"):
            want = np.zeros_like(want)
        np.testing.assert_array_equal(want, getattr(rt, k).numpy(), err_msg=k)
    assert int((rt.pid >= 0).sum()) == gt.n
    assert not bool(rt.overflow)
    # the kernel regrouped particles, so slots moved
    assert not torch.equal(rt.pid, gt.pid)


def test_overflow_latches_on_capacity_violation(displaced):
    _, gt = displaced
    m = gt.mask
    # cram everything into a few cells: ranks pass CAP and particles that
    # moved more than one cell are lost, either of which latches overflow
    cram = {k: torch.where(m, getattr(gt, k) * (0.1 / 24.0), getattr(gt, k))
            for k in ("x", "y", "z")}
    g2 = gt.replace(**cram)
    _, _, over = make_rebin_kernel(gt.spec)(
        torch.stack([g2.x, g2.y, g2.z, g2.vx, g2.vy, g2.vz, (g2.pid + 1).float()]))
    assert int(over) > 0
    assert bool(rebin_fast(g2).overflow)
    assert bool(rebin_fast_noforce(g2).overflow)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("q", [7, 10])
def test_cuda_kernel_matches_plain_exactly(cuda, displaced, q):
    _, gt = displaced
    qs = [gt.x, gt.y, gt.z, gt.vx, gt.vy, gt.vz, gt.fx, gt.fy, gt.fz][: q - 1]
    stacked = torch.stack(qs + [(gt.pid + 1).float()])
    kern = make_rebin_kernel(gt.spec)
    launches = REBIN.launches
    out_c, count_c, over_c = kern(stacked.to(cuda))
    torch.cuda.synchronize()
    assert REBIN.launches == launches + 1
    out_p, count_p, over_p = kern(stacked)
    assert torch.equal(out_c.cpu(), out_p)
    assert (int(count_c), int(over_c)) == (int(count_p), int(over_p)) == (gt.n, 0)

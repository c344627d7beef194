"""The port's pair-force kernel (uammd_tpu_torch.engine.pair_kernel)
against the JAX package's Pallas kernel (interpret mode on the CPU).

Tolerance: max|df| / max|f| < 1e-5 over occupied slots, the tolerance of
tests/test_engine.py:41 — float32 sums taken in a different order. The
CUDA kernel is held against the plain version on the GPU (skips without
one) and, at the benchmark's shapes, by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import layout as jl
from uammd_tpu.engine.md import lj_g as j_lj_g
from uammd_tpu.engine.pair_kernel import make_pair_force_kernel as j_make
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine.md import lj_g
from uammd_tpu_torch.engine.pair_kernel import PAIR_FORCE, make_pair_force_kernel

# (seed, n, L): the systems of tests/test_engine.py:24-29 (fold 2, NLANE 16)
# and :46-48 (fold 4, NLANE 48)
SYSTEMS = {"n1500_fold2": (2, 1500, 24.0), "n2000_fold4": (3, 2000, 36.0)}


def _system(name):
    seed, n, L = SYSTEMS[name]
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) - 0.5) * L
    return tl.choose_spec(L, n, 2.5), pos


def _rel_err(f_ref, f_test, mask):
    fmax = max(np.abs(a[mask]).max() for a in f_ref)
    return max(np.abs(a[mask] - b[mask]).max() for a, b in zip(f_ref, f_test)) / fmax


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_plain_matches_jax_kernel(name):
    spec, pos = _system(name)
    gt = tl.pack(spec, pos, device="cpu")
    # the port packs slot for slot as the JAX package does (test_torch_layout)
    xyz = [jnp.asarray(a.numpy()) for a in (gt.x, gt.y, gt.z)]
    spec_j = jl.choose_spec(spec.box_size, pos.shape[0], 2.5)
    f_jax = [np.asarray(a) for a in j_make(spec_j, j_lj_g())(*xyz)]
    launches = PAIR_FORCE.launches
    f_port = [a.numpy() for a in make_pair_force_kernel(spec, lj_g())(gt.x, gt.y, gt.z)]
    assert PAIR_FORCE.launches == launches  # the CPU path launches nothing
    mask = gt.mask.numpy()
    assert _rel_err(f_jax, f_port, mask) < 1e-5
    assert all(np.isfinite(a).all() for a in f_port)


def test_wrapper_rejects_bad_input():
    spec, pos = _system("n1500_fold2")
    gt = tl.pack(spec, pos, device="cpu")
    force = make_pair_force_kernel(spec, lj_g())
    with pytest.raises(ValueError):
        force(gt.x.double(), gt.y, gt.z)
    with pytest.raises(ValueError):
        force(gt.x[:, :, :-1], gt.y, gt.z)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_cuda_kernel_matches_plain(cuda, name):
    spec, pos = _system(name)
    gs = tl.pack(spec, pos, device=cuda)
    force = make_pair_force_kernel(spec, lj_g())
    launches = PAIR_FORCE.launches
    f_cuda = [a.cpu().numpy() for a in force(gs.x, gs.y, gs.z)]
    torch.cuda.synchronize()
    assert PAIR_FORCE.launches == launches + 1
    f_plain = [a.numpy() for a in force(gs.x.cpu(), gs.y.cpu(), gs.z.cpu())]
    assert _rel_err(f_plain, f_cuda, gs.mask.cpu().numpy()) < 1e-5

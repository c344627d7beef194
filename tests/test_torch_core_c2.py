"""The port's quaternions and logging (uammd_tpu_torch.core.quaternion,
core.logging) against the JAX package's.

- the seven quaternion functions on seeded inputs, small rotation vectors
  (the Taylor branch) included: float64 within 1e-12, float32 within 1e-6;
- logging: levels prune, ``critical`` raises the one ``SimulationError``
  that ``integrators.base.run(guard=True)`` raises too, ``Timer``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core import quaternion as jq
from uammd_tpu_torch.core import logging as tlog
from uammd_tpu_torch.core import quaternion as tq

DT = {"float64": (np.float64, 1e-12), "float32": (np.float32, 1e-6)}


def _inputs(np_dt, n=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p = rng.normal(size=(n, 4))
    v = rng.normal(size=(n, 3)) * rng.choice([1e-9, 1e-7, 0.3, 2.0], size=(n, 1))
    v[0] = 0.0
    x = rng.normal(size=(n, 3))
    return [a.astype(np_dt) for a in (q, p, v, x)]


CASES = {
    "multiply": (lambda m, q, p, v, x: m.multiply(q, p)),
    "from_rotation_vector": (lambda m, q, p, v, x: m.from_rotation_vector(v)),
    "rotate": (lambda m, q, p, v, x: m.rotate(q, x)),
    "normalize": (lambda m, q, p, v, x: m.normalize(p)),
    "apply_rotation": (lambda m, q, p, v, x: m.apply_rotation(q, v)),
    "basis": (lambda m, q, p, v, x: m.basis(q)),
}


@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("name", list(CASES))
def test_quaternion_functions_match_jax(name, dt):
    np_dt, tol = DT[dt]
    args = _inputs(np_dt)
    fn = CASES[name]
    want = np.asarray(jax.jit(lambda *a: fn(jq, *a))(*map(jnp.asarray, args)))
    got = fn(tq, *map(torch.as_tensor, args)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_identity_and_rotation_properties():
    q = tq.identity(5, torch.float64, device="cpu")
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq.identity(5, jnp.float64)))
    # a quarter turn about z takes x to y; the basis of the identity is I
    r = tq.from_rotation_vector(torch.tensor([[0.0, 0.0, np.pi / 2]], dtype=torch.float64))
    np.testing.assert_allclose(tq.rotate(r, torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)),
                               [[0.0, 1.0, 0.0]], atol=1e-15)
    np.testing.assert_array_equal(tq.basis(q)[0].numpy(), np.eye(3))


def test_logging_levels_critical_and_timer(capsys):
    from uammd_tpu_torch.core.state import make_state
    from uammd_tpu_torch.integrators import base

    level = tlog.MAX_LOG_LEVEL
    try:
        tlog.set_level(tlog.MESSAGE)
        tlog.message("hello %d", 42)
        tlog.debug("pruned")
        tlog.log(tlog.STDOUT, "to stdout")
        out = capsys.readouterr()
        assert "[MESSAGE]" in out.err and "hello 42" in out.err and "pruned" not in out.err
        assert out.out == ""  # STDOUT (6) is above MESSAGE (4): pruned
        tlog.set_level(tlog.DEBUG)
        tlog.log(tlog.STDOUT, "to stdout")
        assert "[STDOUT]" in capsys.readouterr().out
        with pytest.raises(tlog.SimulationError, match="boom"):
            tlog.critical("boom")
    finally:
        tlog.set_level(level)
    # the one class: run(guard=True) raises it on a non-finite state
    assert base.SimulationError is tlog.SimulationError
    st = make_state(np.full((2, 3), np.nan), device="cpu")
    integ = base.Integrator(init=lambda s, a: (s, a), step=lambda s, a: (s, a))
    with pytest.raises(tlog.SimulationError):
        base.run(integ, st, None, 1, guard=True)
    t = tlog.Timer()
    t.tic()
    assert t.toc() >= 0.0

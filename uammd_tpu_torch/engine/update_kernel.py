"""Gronbech-Jensen Langevin updates with in-kernel noise, fused with the
reaction fold or not.

Port of ``uammd_tpu/engine/update_kernel.py:make_gj_fold_update_kernel``
(#12) and ``make_gj_update_kernel`` (#11). #12 is one elementwise pass per
step: fold the Newton pair kernel's reaction
groups into the home force, complete the deferred half kick
(v = w + (dt/2m) f), apply the G-J update (reference:
src/Integrator/VerletNVT/GronbechJensen.cu:20-62), write x, y, z and the new
pre-half-kick velocity w, and return the largest infinity-norm drift since
the last rebin.

Noise. The JAX kernel draws from the TPU's hardware PRNG, a stream nothing
else reproduces. The port draws from a counter-based hash instead,
Philox-4x32-10 (the reference's idiom, third_party/saruprng.cuh), keyed by
the step seed (``GridState.step``) and counted by the global slot index, so
the CUDA kernel and the plain version draw the same numbers: the plain
version computes the hash in int64 torch arithmetic with masks. Two
generators, as in the JAX package: ``"clt"`` (variance-exact sums of four
16-bit uniforms, bounded at 2 sqrt(3) sigma) and ``"bm"`` (Box-Muller on
mantissa-trick uniforms in (0, 1]).

The straggler rows of the v2 engine get the same update in the same call
(the JAX engine runs it as separate jnp ops, md2.py:190-213), with the
counter hash's stream 1 under the same seed; a step then launches no
per-row noise arithmetic of its own.

On CUDA tensors the wrapper launches ``csrc/gj_fold_update.cu``; on CPU
tensors it runs ``gj_fold_update_plain``.

#11 (``GJUpdateKernel``) is the same update from already folded forces,
which the v2 engine runs when the fold is a pass of its own
(``fold_in_update=False``) and the DD2 step runs on every shard. It has
Box-Muller noise only (the JAX kernel has no switch) from the same counter
hash, key, slot counters and streams as #12, and updates the straggler
rows in the same call, so a fused and an unfused run draw the same
numbers. Given the straggler rows' reference positions (``sref``) it also
folds their drift into the one it returns, as JAX's DD2 step does
(domain2.py:409-413). CUDA tensors launch ``csrc/gj_update.cu``; CPU
tensors run ``gj_update_plain``, and ``gj_update_z`` takes the three
standard-normal fields from the caller (the CPU tests feed it
``jax.random``'s draws, as ``gj_update_jnp`` makes them).

Drift. Every update returns JAX's drift as XLA compiles ``gj_update_jnp``
(update_kernel.py:354, where ``mask * y`` becomes a select): the maximum
over slots of ``where(mask, max(|x' - rx|, |y' - ry|, |z' - rz|), 0)``. A
NaN on an occupied slot carries through both maxima, and an empty slot
adds exactly 0 whatever it holds.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from .kernel2 import fold_reactions_plain
from .layout import GridSpec

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p

TWO_PI = float(np.float32(2.0 * math.pi))
NOISES = ("clt", "bm")

# uammd_gj_fold_update(x, y, z, wx, wy, wz, forces [15, ...], rx, ry, rz,
#                      out [6 T + 6 S + 1], seed, scratch, scratch_len, spos,
#                      svel, sforce, spid, S, nz, nyb, plane, noisy, noise, hv,
#                      bdt, c_x, dt, a, hva, bm, scale, stream)
GJ_FOLD_UPDATE = _build.Kernel(
    "gj_fold_update", "uammd_gj_fold_update",
    [_P] * 13 + [ctypes.c_longlong] + [_P] * 4 + [_I] * 6 + [_F] * 8)

# uammd_gj_update(x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz,
#                 out [6 T + 6 S + 1], seed, scratch, scratch_len, spos, svel,
#                 sforce, spid, spid_float, sref, S, params, stream)
GJ_UPDATE = _build.Kernel(
    "gj_update", "uammd_gj_update",
    [_P] * 15 + [ctypes.c_longlong] + [_P] * 4 + [_I, _P, _I, _P])


class _GJParams(ctypes.Structure):
    """#11's scalar arguments, made once a kernel and passed by address
    (``Params`` in ``csrc/gj_update.cu``)."""

    _fields_ = ([(k, _I) for k in ("nz", "nyb", "plane", "noisy")]
                + [(k, _F) for k in ("hv", "bdt", "c_x", "dt", "a", "hva", "bm", "amp")])

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit halves of m * a for uint32 values held in int64,
    through 16-bit halves of ``a`` so that no product passes 2^63."""
    p_lo = m * (a & 0xFFFF)
    p_hi = m * (a >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (mid >> 32)) & _MASK32, mid & _MASK32


def philox4x32(counter, key):
    """Philox-4x32-10 of the counter words ``counter`` (4 int64 tensors or
    ints, uint32 values) under ``key`` (2 of the same); returns 4 int64
    tensors of uint32 values. Mirrors the device function in
    ``csrc/gj_fold_update.cu``."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) & _MASK32 for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) & _MASK32 for k in key)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def counter_bits(seed, index: torch.Tensor, stream: int = 0):
    """Eight uint32 words (int64 tensors shaped like ``index``) for each
    counter ``index`` under ``seed``: Philox with counters (index, 0,
    stream, 0) and (index, 1, stream, 0), key (seed, 0). The update kernel
    uses stream 0 over the grid slots; the straggler update stream 1."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=index.device)
    words = []
    for j in (0, 1):
        words += philox4x32((index, j, stream, 0), (seed, 0))
    return words


def normals(words, noise: str, amp: float):
    """Three pseudo-normal fields of standard deviation ``amp`` (float32)
    from the counter words, with the JAX package's generators."""
    if noise == "clt":
        scale = float(np.float32(amp) * np.float32(math.sqrt(3.0) / 65536.0))
        u = []
        for d in words[:6]:
            u += [(d & 0xFFFF).to(torch.float32), ((d >> 16) & 0xFFFF).to(torch.float32)]
        return tuple(scale * ((u[4 * k] + u[4 * k + 1]) - (u[4 * k + 2] + u[4 * k + 3]))
                     for k in range(3))
    if noise == "bm":
        # (0, 1] uniforms: 1 - (top 23 bits) * 2^-23, exact in float32
        u1, u2, u3, u4 = (1.0 - (d >> 9).to(torch.float32) * 2.0 ** -23 for d in words[:4])
        r1 = torch.sqrt(-2.0 * torch.log(u1))
        r2 = torch.sqrt(-2.0 * torch.log(u3))
        a = float(np.float32(amp))
        return (a * (r1 * torch.cos(TWO_PI * u2)),
                a * (r1 * torch.sin(TWO_PI * u2)),
                a * (r2 * torch.cos(TWO_PI * u4)))
    raise ValueError(f"noise must be one of {NOISES}, got {noise!r}")


class GJCoefficients:
    """The update's float32 coefficients, formed as the JAX kernel forms
    them (update_kernel.py:224-235) and held as Python floats."""

    def __init__(self, dt, temperature, friction, mass):
        dt_ = np.float32(dt)
        m_ = np.float32(mass)
        hv = np.float32(0.5 * dt / mass)
        gdt = 0.5 * friction * dt
        b = np.float32(1.0 / (1.0 + gdt))
        a = np.float32((1.0 - gdt) * b)
        c_x = np.float32(0.5 * b * dt / mass)
        self.noisy = temperature > 0
        self.amp = float(np.float32(
            math.sqrt(2.0 * temperature * friction * mass * dt) if self.noisy else 0.0))
        self.dt = float(dt_)
        self.hv = float(hv)
        self.a = float(a)
        self.c_x = float(c_x)
        self.bdt = float(b * dt_)
        self.hva = float(hv * a)
        self.bm = float(b / m_)


def _gj(coef: GJCoefficients, p, w, f, n_, mask):
    """One component of the update: (p', w') from position, pre-half-kick
    velocity, folded force, noise and the occupied mask, with the JAX
    kernel's grouping (update_kernel.py:258-269)."""
    v = w + coef.hv * f
    return (p + mask * (coef.bdt * v + coef.c_x * (coef.dt * f + n_)),
            mask * (coef.a * v + coef.hva * f + coef.bm * n_))


def _noise(coef: GJCoefficients, noise: str, seed, count: int, device, stream: int):
    if not coef.noisy:
        z = torch.zeros(count, dtype=torch.float32, device=device)
        return z, z, z
    index = torch.arange(count, dtype=torch.int64, device=device)
    return normals(counter_bits(seed, index, stream), noise, coef.amp)


def gj_fold_update_plain(spec: GridSpec, coef: GJCoefficients, noise: str,
                         x, y, z, wx, wy, wz, hfx, hfy, hfz, groups, rx, ry, rz, seed,
                         strag=None):
    """Plain version of the fused kernel: ``fold_reactions_plain`` of the
    home force and the 12 group grids (``groups`` flat, REACTION_GROUPS x
    (x, y, z)), then the update with counter noise keyed by ``seed`` (an
    int or a 0-d tensor). Returns ((x', y', z', wx', wy', wz'), drift), and
    with ``strag = (spos, svel, sforce, spid)`` also the stragglers'
    (spos', svel'), updated with noise stream 1."""
    grp = [tuple(groups[3 * i: 3 * i + 3]) for i in range(4)]
    fx, fy, fz = fold_reactions_plain((hfx, hfy, hfz), grp)
    return _update_plain(spec, coef, noise, x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz,
                         seed, strag)


def _grid_update(coef: GJCoefficients, x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz,
                 noise_fields):
    """((x', y', z', wx', wy', wz'), drift) of the grid slots from folded
    forces and noise fields of standard deviation ``coef.amp``; the drift
    is JAX's select rule (see the module docstring)."""
    occupied = x < 1.0e8
    mask = occupied.to(torch.float32)
    out = [_gj(coef, p, w, f, n_.reshape(x.shape), mask) for p, w, f, n_ in
           zip((x, y, z), (wx, wy, wz), (fx, fy, fz), noise_fields)]
    (xo, wxo), (yo, wyo), (zo, wzo) = out
    dinf = torch.maximum(torch.abs(xo - rx), torch.maximum(torch.abs(yo - ry), torch.abs(zo - rz)))
    return (xo, yo, zo, wxo, wyo, wzo), torch.where(occupied, dinf, 0.0).amax()


def _update_plain(spec: GridSpec, coef: GJCoefficients, noise: str, x, y, z, wx, wy, wz,
                  fx, fy, fz, rx, ry, rz, seed, strag):
    """The update of both plain versions from folded forces, with counter
    noise (stream 0 on the grid slots, 1 on the straggler rows)."""
    fields = _noise(coef, noise, seed, spec.n_slots, x.device, 0)
    grid = _grid_update(coef, x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz, fields)
    if strag is None:
        return grid
    return grid + (_strag_plain(coef, noise, seed, strag),)


def strag_occupied(spid: torch.Tensor) -> torch.Tensor:
    """The occupied straggler rows of ``spid``: int32 pids (-1 empty) or the
    DD2 state's float32 pid + 1 (0 empty; JAX's ``spidf > 0.5``)."""
    return spid > 0.5 if spid.dtype == torch.float32 else spid >= 0


def _strag_plain(coef: GJCoefficients, noise: str, seed, strag):
    """The straggler rows' (spos', svel'), with noise stream 1."""
    spos, svel, sforce, spid = strag
    smask = strag_occupied(spid).to(torch.float32)
    sn = _noise(coef, noise, seed, spid.shape[0], spos.device, 1)
    sout = [_gj(coef, spos[:, c], svel[:, c], sforce[:, c], sn[c], smask) for c in range(3)]
    return (torch.stack([o[0] for o in sout], dim=-1),
            torch.stack([o[1] for o in sout], dim=-1))


def strag_drift_plain(drift, spos_new, sref, spid):
    """``drift`` joined with the straggler rows' own, as JAX's DD2 step
    takes it (domain2.py:409-413): ``maximum(drift, max(where(occupied,
    |spos' - sref|, 0)))``, NaN kept by both maxima."""
    if spid.shape[0] == 0:
        return drift
    occupied = strag_occupied(spid)[:, None]
    return torch.maximum(drift, torch.where(occupied, torch.abs(spos_new - sref), 0.0).amax())


def gj_fold_update_scratch(dev, spec: GridSpec, S: int) -> torch.Tensor:
    """A zeroed int32 scratch for #12's launches on ``dev`` with ``S``
    straggler rows, of the length its library asks for
    (``uammd_gj_fold_update_scratch``: a drift maximum a block, then the
    ticket counter)."""
    size = _build.load("gj_fold_update").uammd_gj_fold_update_scratch
    size.restype = ctypes.c_longlong
    nz, nyb, cap, nlane = spec.array_shape
    n = size(ctypes.c_int(nz), ctypes.c_int(nyb), ctypes.c_int(cap * nlane), ctypes.c_int(S))
    return torch.zeros(int(n), dtype=torch.int32, device=dev)


class GJFoldUpdateKernel:
    """``update(x, y, z, wx, wy, wz, hfx, hfy, hfz, groups12, rx, ry, rz,
    seed[, strag]) -> ((x', y', z', wx', wy', wz'), drift[, (spos',
    svel')])`` for one ``GridSpec``; ``seed`` is the 0-d int32
    ``GridState.step`` (read on the device by the kernel), ``drift`` a 0-d
    float32 tensor and ``strag`` the straggler rows (spos, svel, sforce
    [S, 3] float32, spid [S] int32). ``update.stacked(x, y, z, wx, wy, wz,
    forces, rx, ry, rz, seed[, strag])`` is the same with the 15 force grids
    as one [15, nz, nyb, CAP, NLANE] buffer, the Newton pair kernel's output
    as ``NewtonPairKernel.stacked`` returns it (home x, y, z, then group g
    channel c at 3 + 3 g + c).

    CPU tensors go to ``gj_fold_update_plain``; CUDA tensors launch
    ``csrc/gj_fold_update.cu`` (counted in ``GJ_FOLD_UPDATE.launches``; the
    list form stacks its forces first) or raise. The kernel keeps a small
    int32 scratch on the instance (a drift maximum a block and a ticket
    counter that the launch resets), so one instance serves one stream at a
    time."""

    def __init__(self, spec: GridSpec, dt, temperature, friction, mass, *, noise="bm"):
        if noise not in NOISES:
            raise ValueError(f"noise must be one of {NOISES}, got {noise!r}")
        self.spec = spec
        self.noise = noise
        self.coef = GJCoefficients(dt, temperature, friction, mass)
        c = self.coef
        scale = (float(np.float32(c.amp) * np.float32(math.sqrt(3.0) / 65536.0))
                 if noise == "clt" else c.amp)
        nz, nyb, cap, nlane = spec.array_shape
        self._shape = torch.Size(spec.array_shape)
        self._fshape = torch.Size((15,) + spec.array_shape)
        # the launch's arguments after the straggler count
        self._tail = (nz, nyb, cap * nlane, int(c.noisy), NOISES.index(noise),
                      c.hv, c.bdt, c.c_x, c.dt, c.a, c.hva, c.bm, scale)
        self._scratch = {}  # (device, S) -> the launch's int32 scratch

    def __call__(self, x, y, z, wx, wy, wz, hfx, hfy, hfz, groups, rx, ry, rz, seed,
                 strag=None):
        spec = self.spec
        shape = spec.array_shape
        forces = [hfx, hfy, hfz, *groups]
        if len(forces) != 15:
            raise ValueError("update takes 12 reaction-group grids")
        if x.device.type == "cpu":
            for t in [x, y, z, wx, wy, wz, *forces, rx, ry, rz]:
                if t.device.type != "cpu" or t.dtype != torch.float32 or tuple(t.shape) != shape:
                    raise ValueError(f"update inputs must be float32 CPU tensors of shape {shape}")
            return gj_fold_update_plain(spec, self.coef, self.noise, x, y, z, wx, wy, wz,
                                        hfx, hfy, hfz, groups, rx, ry, rz, seed, strag)
        _build.check_cuda_tensors(forces, "update force", shape)
        return self.stacked(x, y, z, wx, wy, wz, torch.stack(forces), rx, ry, rz, seed, strag)

    def stacked(self, x, y, z, wx, wy, wz, forces, rx, ry, rz, seed, strag=None):
        shape = self._shape
        grids = (x, y, z, wx, wy, wz, rx, ry, rz)
        if x.device.type == "cpu":
            named = [(f"update grid {k}", t, shape) for k, t in enumerate(grids)]
            for name, t, shp in named + [("forces", forces, self._fshape)]:
                if t.device.type != "cpu" or t.dtype != torch.float32 or t.shape != shp:
                    raise ValueError(f"{name} must be a float32 CPU tensor of shape "
                                     f"{tuple(shp)}")
            return gj_fold_update_plain(self.spec, self.coef, self.noise, x, y, z, wx, wy, wz,
                                        forces[0], forces[1], forces[2], forces[3:], rx, ry, rz,
                                        seed, strag)
        _build.check_cuda_tensors(grids, "update grid", shape)
        _build.check_cuda_tensor(forces, "forces", self._fshape)
        if self._tail[2] % 4:
            raise ValueError(f"the update reads 4 slots at a time: CAP x NLANE = "
                             f"{self._tail[2]} is not a multiple of 4")
        if not (seed.is_cuda and seed.dtype is torch.int32 and seed.dim() == 0):
            _build.check_cuda_tensor(seed, "seed", (), dtype=torch.int32)
        if strag is None:
            S, sp = 0, (None,) * 4
        else:
            S = strag[3].shape[0]
            _build.check_cuda_tensors(strag[:3], "straggler input", (S, 3))
            _build.check_cuda_tensor(strag[3], "spid", (S,), dtype=torch.int32)
            sp = tuple(t.data_ptr() for t in strag)
        T = self.spec.n_slots
        dev = x.device
        buf = torch.empty(6 * T + 6 * S + 1, dtype=torch.float32, device=dev)
        scratch = self._scratch.get((dev, S))
        if scratch is None:  # zeroed once; the launches keep it so
            scratch = self._scratch[(dev, S)] = gj_fold_update_scratch(dev, self.spec, S)
        GJ_FOLD_UPDATE(x.data_ptr(), y.data_ptr(), z.data_ptr(), wx.data_ptr(), wy.data_ptr(),
                       wz.data_ptr(), forces.data_ptr(), rx.data_ptr(), ry.data_ptr(),
                       rz.data_ptr(), buf.data_ptr(), seed.data_ptr(), scratch.data_ptr(),
                       scratch.numel(), *sp, S, *self._tail)
        grid = (buf[:6 * T].view((6,) + shape).unbind(0), buf[6 * T + 6 * S])
        if strag is None:
            return grid
        return grid + (buf[6 * T:6 * T + 6 * S].view(2, S, 3).unbind(0),)


def make_gj_fold_update_kernel(spec: GridSpec, dt, temperature, friction, mass, *,
                               noise: str = "bm") -> GJFoldUpdateKernel:
    """Build the fused fold + G-J update for one spec and parameter set."""
    return GJFoldUpdateKernel(spec, dt, temperature, friction, mass, noise=noise)


# ---------------------------------------------------------------------------
# #11: the update from folded forces (fold_in_update off)


def gj_update_z(coef: GJCoefficients, x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz,
                nx, ny, nz):
    """The update with the caller's standard-normal fields ``nx, ny, nz``
    (shaped like ``x``; ignored at T = 0), as ``gj_update_jnp`` forms it
    with ``amp * jax.random.normal(...)``. Returns ((x', y', z', wx', wy',
    wz'), drift)."""
    if coef.noisy:
        fields = (coef.amp * nx, coef.amp * ny, coef.amp * nz)
    else:
        fields = (torch.zeros_like(x),) * 3
    return _grid_update(coef, x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz, fields)


def gj_update_plain(spec: GridSpec, coef: GJCoefficients, x, y, z, wx, wy, wz, fx, fy, fz,
                    rx, ry, rz, seed, strag=None, sref=None):
    """Plain version of #11: the update from folded forces with "bm"
    counter noise keyed by ``seed`` (the fused update's streams). Returns
    ((x', y', z', wx', wy', wz'), drift), and with ``strag = (spos, svel,
    sforce, spid)`` (``spid`` int32 pids or float32 pid + 1) also the
    stragglers' (spos', svel'); with ``sref`` (their positions at the last
    rebin) the drift takes in theirs (``strag_drift_plain``)."""
    res = _update_plain(spec, coef, "bm", x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz,
                        seed, strag)
    if sref is None:
        return res
    if strag is None:
        raise ValueError("sref needs the straggler rows")
    return res[0], strag_drift_plain(res[1], res[2][0], sref, strag[3]), res[2]


def gj_update_scratch(dev, spec: GridSpec, S: int) -> torch.Tensor:
    """A zeroed int32 scratch for #11's launches on ``dev`` with ``S``
    straggler rows (``uammd_gj_update_scratch``: a drift maximum a block,
    then the ticket counter)."""
    lib = _build.load("gj_update")
    if lib.uammd_gj_update_params_size() != ctypes.sizeof(_GJParams):
        raise RuntimeError("csrc/gj_update.cu's Params block differs from _GJParams")
    size = lib.uammd_gj_update_scratch
    size.restype = ctypes.c_longlong
    nz, nyb, cap, nlane = spec.array_shape
    n = size(ctypes.c_int(nz), ctypes.c_int(nyb), ctypes.c_int(cap * nlane), ctypes.c_int(S))
    return torch.zeros(int(n), dtype=torch.int32, device=dev)


class GJUpdateKernel:
    """``update(x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz, seed[, strag[,
    sref]]) -> ((x', y', z', wx', wy', wz'), drift[, (spos', svel')])`` for
    one ``GridSpec``, from folded forces; ``seed`` the 0-d int32 step seed
    (read on the device), ``strag = (spos, svel, sforce, spid)`` the
    straggler rows ([S, 3] float32; ``spid`` [S] int32 pids, -1 empty, or
    float32 pid + 1, 0 empty, the DD2 state's form) and ``sref`` [S, 3]
    their positions at the last rebin, whose drift then joins the grid's.

    CPU tensors go to ``gj_update_plain``; CUDA tensors launch
    ``csrc/gj_update.cu`` (counted in ``GJ_UPDATE.launches``) or raise. The
    outputs are views of one fresh buffer. The kernel keeps a small int32
    scratch on the instance (a drift maximum a block and a ticket counter
    that the launch resets), so one instance serves one stream at a
    time."""

    def __init__(self, spec: GridSpec, dt, temperature, friction, mass):
        self.spec = spec
        self.coef = c = GJCoefficients(dt, temperature, friction, mass)
        nz, nyb, cap, nlane = spec.array_shape
        self._shape = torch.Size(spec.array_shape)
        self._T = T = spec.n_slots
        self._grids_at = ((6,) + spec.array_shape, (T, nyb * cap * nlane, cap * nlane, nlane, 1))
        self._params = _GJParams(nz, nyb, cap * nlane, int(c.noisy), c.hv, c.bdt, c.c_x,
                                 c.dt, c.a, c.hva, c.bm, c.amp)
        self._params_at = ctypes.addressof(self._params)
        self._plane_odd = (cap * nlane) % 4 != 0
        self._scratch = {}  # (device, S) -> (the launch's int32 scratch, its pointer, length)

    def __call__(self, x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz, seed, strag=None,
                 sref=None):
        grids = (x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz)
        if sref is not None and strag is None:
            raise ValueError("sref needs the straggler rows")
        dev = x.device
        shape = self._shape
        if dev.type == "cpu":
            for t in grids:
                if t.device.type != "cpu" or t.dtype != torch.float32 or t.shape != shape:
                    raise ValueError(f"update inputs must be float32 CPU tensors of shape "
                                     f"{tuple(shape)}")
            return gj_update_plain(self.spec, self.coef, *grids, seed, strag, sref)
        # only what the kernel cannot survive: a CUDA float32 contiguous
        # tensor of the right shape, a plane of whole 16-byte words
        _build.check_cuda_tensors(grids, "update grid", shape)
        if self._plane_odd:
            raise ValueError(f"the update reads 4 slots at a time: CAP x NLANE = "
                             f"{self._params.plane} is not a multiple of 4")
        if not (seed.is_cuda and seed.dtype is torch.int32 and seed.dim() == 0):
            _build.check_cuda_tensor(seed, "seed", (), dtype=torch.int32)
        S, sp, spid_float, rp = 0, (None,) * 4, 0, None
        if strag is not None:
            spos, svel, sforce, spid = strag
            S = spid.shape[0]
            _build.check_cuda_tensors(strag[:3], "straggler input", (S, 3))
            spid_float = int(spid.dtype is torch.float32)
            if not (spid_float and spid.is_cuda and spid.shape == (S,)
                    and spid.is_contiguous()):
                _build.check_cuda_tensor(spid, "spid", (S,), dtype=torch.int32)
            sp = (spos.data_ptr(), svel.data_ptr(), sforce.data_ptr(), spid.data_ptr())
            if sref is not None:
                _build.check_cuda_tensors((sref,), "sref", (S, 3))
                rp = sref.data_ptr()
        T6 = 6 * self._T
        buf = torch.empty(T6 + 6 * S + 1, dtype=torch.float32, device=dev)
        scratch = self._scratch.get((dev, S))
        if scratch is None:  # zeroed once; the launches keep it so
            t = gj_update_scratch(dev, self.spec, S)
            scratch = self._scratch[(dev, S)] = (t, t.data_ptr(), t.numel())
        GJ_UPDATE(x.data_ptr(), y.data_ptr(), z.data_ptr(), wx.data_ptr(), wy.data_ptr(),
                  wz.data_ptr(), fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), rx.data_ptr(),
                  ry.data_ptr(), rz.data_ptr(), buf.data_ptr(), seed.data_ptr(), scratch[1],
                  scratch[2], *sp, spid_float, rp, S, self._params_at)
        grid = (buf.as_strided(*self._grids_at).unbind(0), buf[T6 + 6 * S])
        if strag is None:
            return grid
        rows = (S, 3), (3, 1)
        return grid + ((buf.as_strided(*rows, T6), buf.as_strided(*rows, T6 + 3 * S)),)


def make_gj_update_kernel(spec: GridSpec, dt, temperature, friction, mass) -> GJUpdateKernel:
    """Build the G-J update from folded forces (#11) for one spec."""
    return GJUpdateKernel(spec, dt, temperature, friction, mass)

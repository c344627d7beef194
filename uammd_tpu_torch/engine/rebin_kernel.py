"""In-place cell rebinning of the grid-resident layout.

Port of ``uammd_tpu/engine/rebin_kernel.py:make_rebin_kernel`` with
``rebin_fast`` / ``rebin_fast_noforce``. Each destination cell pulls the
particles whose current position falls in it from its 27-cell neighborhood
(particles move at most one cell between rebins, guaranteed by the
half-skin drift trigger) and compacts them into its CAP slots in a fixed
order: source cells by (dz, dy, dx), each in (-1, 0, 1), then source slots
ascending. That is the TPU kernel's rank order, so the result equals it
slot for slot.

Quantities travel stacked as [Q, nz, nyb, CAP, NLANE] float32 with x, y, z
first and pid+1 last (exact to 2^24 particles); positions are wrapped into
the primary box on the way and empty slots get EMPTY_POS (x, y, z) and 0.

The wrap comes before the cell test, in every rebin of this module (#3, #4
and #5): a candidate's destination is the cell of its wrapped coordinate
wrap(p) = p - L round(p / L), with no image shift, and that wrapped value is
what is stored. It is the sort rebin's rule (``layout.rebin``), so every
rebin keeps a particle that moved at most one cell and stores it bit for
bit as the sort rebin does. The JAX package's kernels test the
image-shifted coordinate p +- L before it is wrapped; on a few float32
values within ulps of a face of the box (and for a particle stored in x
cell 0 at +L/2 that then moves) that loses the particle or stores another
representative, and there the port differs from them by design.

The call returns ``(out, count, overflow)``: the number of particles found
and the number ranked past CAP. The caller latches overflow when
``overflow > 0`` or ``count != n`` (a particle moved more than one cell).

On CUDA tensors the wrapper launches ``csrc/rebin.cu``; on CPU tensors it
runs ``rebin_plain``.

The v2 engine's straggler-aware rebin is the port of
``make_separable_rebin`` with ``rebin_fast3``: three passes, z (absorbing
the straggler list) then y then x, each pulling from the 3 neighbor cells
along its axis at the wide capacity CAP + OCAP; ranks CAP .. CAP+OCAP-1 of
the x pass form the overflow mini-grid that becomes the next straggler
list. CPU tensors run ``separable_rebin_plain``, the passes themselves;
CUDA tensors launch ``csrc/sep_rebin.cu``, which gives their result in one
classify-and-pull pair with no intermediate grid (each cell ranks its
particles in the order the passes leave them, and counts the passes'
intermediate occupancies for the overflow).

The one-shot alternative is the port of ``make_rebin_kernel2`` (#4) with
``rebin_fast2``: each cell pulls from its 27 neighbor cells, as the v1
rebin does, and then from the whole straggler list; ranks CAP ..
CAP+OCAP-1 form the overflow mini-grid. CUDA tensors launch
``csrc/rebin2.cu`` (#5's classify-and-pull pair, ranked in #3's order with
the straggler rows last), CPU tensors run ``rebin2_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .layout import EMPTY_POS, OCAP, GridSpec, GridState, recip32, stencil_sources

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p

# uammd_rebin(in, codes, out, counts, Q, nx, nyb, nz, F, cap, Lx, Ly, Lz,
#             1/Lx, 1/Ly, 1/Lz, stream)
REBIN = _build.Kernel("rebin", "uammd_rebin", [_P] * 4 + [_I] * 6 + [_F] * 6)


def rebin_launch_plan(spec: GridSpec) -> dict:
    """The launch of ``csrc/rebin.cu`` for ``spec``: the classify kernel's
    blocks and threads, and the pull kernel's blocks, threads and dynamic
    shared memory (a rank table [CAP][NLANE] of int32 and a fill count a
    cell), as the C entry computes them; the code scratch's bytes."""
    nx, _, nz = spec.shape
    cpad = (spec.cap + 15) // 16 * 16
    blocks = spec.nyb * nz
    return {"classify_blocks": blocks, "classify_threads": spec.nlane * (cpad // 16),
            "pull_blocks": blocks, "pull_threads": (4 * spec.nlane + 31) // 32 * 32,
            "pull_smem_bytes": 4 * (spec.cap + 1) * spec.nlane,
            "code_bytes": nz * spec.nyb * spec.nlane * cpad}


def _dest_cell(p, L, n):
    # floor((p/L + 0.5 - floor(p/L + 0.5)) * n); p/L as the TPU kernel
    # computes it after XLA's rewrite, p * float32(1/L)
    fr = p * recip32(L) + 0.5
    return torch.floor((fr - torch.floor(fr)) * float(n))


def _wrap_pos(p, L):
    return (p - L * torch.round(p * recip32(L))) + 0.0


def _wrapped_cell(p, L, n):
    """(the wrapped coordinate, its cell as a float): the rule of every
    rebin here, the sort rebin's."""
    w = _wrap_pos(p, L)
    return w, _dest_cell(w, L, n)


def rebin_plain(spec: GridSpec, stacked: torch.Tensor):
    """Plain PyTorch version of the kernel: the 27 candidate cells are
    visited in the kernel's order and each candidate's rank is the running
    count of valid candidates before it (an exclusive cumsum per cell). A
    candidate belongs to the cell of its wrapped coordinate."""
    n_q = stacked.shape[0]
    nx, ny, nz = spec.shape
    F, cap, nlane, nyb = spec.fold, spec.cap, spec.nlane, spec.nyb
    Lx, Ly, Lz = spec.box_size
    dev = stacked.device
    lane = torch.arange(nlane, device=dev)
    my_cx = (lane // F).to(torch.float32)[None, None, None, :]
    my_cy = (torch.arange(nyb, device=dev)[:, None] * F + lane[None, :] % F)
    my_cy = my_cy.to(torch.float32)[None, :, None, :]
    my_cz = torch.arange(nz, device=dev).to(torch.float32)[:, None, None, None]
    rows = torch.arange(cap, device=dev)[None, None, :, None]
    shape = (nz, nyb, cap, nlane)
    zd = torch.arange(nz, device=dev)[:, None, None, None].expand(shape)
    yd = torch.arange(nyb, device=dev)[None, :, None, None].expand(shape)
    ld = lane[None, None, None, :].expand(shape)

    out = torch.zeros_like(stacked)
    base = torch.zeros((nz, nyb, 1, nlane), dtype=torch.int64, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    over = torch.zeros((), dtype=torch.int64, device=dev)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zs, ybs, ls, _ = stencil_sources(spec, dz, dy, dx, dev)
                cand = stacked[:, zs, ybs, rows, ls]  # [Q, nz, nyb, cap, nlane]
                (wx, cx), (wy, cy), (wz, cz) = (
                    _wrapped_cell(cand[d], L_, n_) for d, (L_, n_) in
                    enumerate(zip((Lx, Ly, Lz), (nx, ny, nz))))
                valid = (cand[n_q - 1] > 0.5) & (cx == my_cx) & (cy == my_cy) & (cz == my_cz)
                v = valid.to(torch.int64)
                rank = base + torch.cumsum(v, dim=2) - v
                base = base + v.sum(dim=2, keepdim=True)
                count = count + v.sum()
                over = over + (valid & (rank >= cap)).sum()
                place = valid & (rank < cap)
                vals = torch.stack([wx, wy, wz] + [cand[q] + 0.0 for q in range(3, n_q)])
                out[:, zd[place], yd[place], rank[place], ld[place]] = vals[:, place]
    unfilled = rows >= base  # [nz, nyb, cap, nlane]
    out[:3] = torch.where(unfilled, torch.full_like(out[:3], EMPTY_POS), out[:3])
    return out, count, over


class RebinKernel:
    """``rebin_stacked(stacked [Q, nz, nyb, CAP, NLANE]) -> (out, count,
    overflow)`` for one ``GridSpec``; Q is read from the input.

    CPU tensors go to ``rebin_plain``; CUDA tensors launch ``csrc/rebin.cu``
    (its two kernels, one count in ``REBIN.launches``) or raise."""

    def __init__(self, spec: GridSpec):
        self.spec = spec

    def __call__(self, stacked: torch.Tensor):
        spec = self.spec
        if stacked.dim() != 5 or stacked.shape[0] < 4:
            raise ValueError("stacked must be [Q >= 4, nz, nyb, CAP, NLANE]")
        shape = (stacked.shape[0],) + spec.array_shape
        if stacked.device.type == "cpu":
            if stacked.dtype != torch.float32 or tuple(stacked.shape) != shape:
                raise ValueError(f"stacked must be a float32 tensor of shape {shape}")
            return rebin_plain(spec, stacked)
        if shape[0] not in (7, 10):
            raise ValueError(f"the rebin kernel carries Q = 7 or 10 quantities, not {shape[0]}")
        _build.check_cuda_tensor(stacked, "stacked", shape)
        nx, _, nz = spec.shape
        Lx, Ly, Lz = spec.box_size
        out = torch.empty_like(stacked)
        counts = torch.zeros(2, dtype=torch.int32, device=stacked.device)
        codes = torch.empty(rebin_launch_plan(spec)["code_bytes"], dtype=torch.uint8,
                            device=stacked.device)
        P = _build.ptr
        REBIN(
            P(stacked), P(codes), P(out), P(counts), shape[0],
            nx, spec.nyb, nz, spec.fold, spec.cap,
            Lx, Ly, Lz, recip32(Lx), recip32(Ly), recip32(Lz),
        )
        return out, counts[0], counts[1]


def make_rebin_kernel(spec: GridSpec) -> RebinKernel:
    """Build ``rebin_stacked(stacked) -> (out, count, overflow)``. Nothing
    is compiled per spec: the kernel takes the geometry at run time, and the
    built library is loaded once per process (``_build.load``), which is
    what the JAX package's per-(spec, Q) kernel cache holds."""
    return RebinKernel(spec)


def _rebin_quantities(gs: GridState, quantities):
    stacked = torch.stack(list(quantities) + [(gs.pid + 1).to(torch.float32)])
    out, count, ovf = RebinKernel(gs.spec)(stacked)
    pid = out[-1].to(torch.int32) - 1
    overflow = gs.overflow | (ovf > 0) | (count != gs.n)
    return out, pid, overflow


def rebin_fast(gs: GridState) -> GridState:
    """Drop-in replacement for ``layout.rebin`` through the rebin kernel,
    carrying positions, velocities and forces (Q = 10)."""
    out, pid, overflow = _rebin_quantities(
        gs, (gs.x, gs.y, gs.z, gs.vx, gs.vy, gs.vz, gs.fx, gs.fy, gs.fz))
    return gs.replace(
        x=out[0], y=out[1], z=out[2],
        vx=out[3], vy=out[4], vz=out[5],
        fx=out[6], fy=out[7], fz=out[8],
        pid=pid, ref_x=out[0], ref_y=out[1], ref_z=out[2],
        overflow=overflow,
    )


# uammd_sep_rebin(in, strag, scratch, out, mini, Q, S, nx, nyb, nz, F, cap,
#                 ocap, order, Lx, Ly, Lz, 1/Lx, 1/Ly, 1/Lz, stream)
SEP_REBIN = _build.Kernel("sep_rebin", "uammd_sep_rebin", [_P] * 5 + [_I] * 9 + [_F] * 6)


def sep_rebin_launch_plan(spec: GridSpec, ocap: int = OCAP) -> dict:
    """The launch of ``csrc/sep_rebin.cu`` for ``spec``: #3's classify
    kernel with one more row of blocks for the straggler rows, and the
    pull kernel's blocks, threads and dynamic shared memory (a rank table
    [CAP + ocap][NLANE] of int32, a fill count a cell, 32 warp counts and a
    straggler list of S), as the C entry computes them; the scratch's
    bytes (the code bytes, an int32 cell a straggler row, the two int32
    counts)."""
    nx, _, nz = spec.shape
    cpad = (spec.cap + 15) // 16 * 16
    S = spec.n_strag
    return {"classify_blocks": spec.nyb * (nz + 1), "classify_threads": spec.nlane * (cpad // 16),
            "pull_blocks": spec.nyb * nz, "pull_threads": (4 * spec.nlane + 31) // 32 * 32,
            "pull_smem_bytes": 4 * ((spec.cap + ocap + 1) * spec.nlane + 32 + S),
            "scratch_bytes": nz * spec.nyb * spec.nlane * cpad + 4 * (S + 2)}


def _rank_into(out: torch.Tensor, base: torch.Tensor, vals: torch.Tensor,
               valid: torch.Tensor):
    """Place the valid candidates ``vals`` [Q, nz, nyb, R, NLANE] of each
    cell at their ranks, ``base`` plus the count of valid candidates
    before them along R, in ``out`` [Q, nz, nyb, depth, NLANE]; ranks past
    depth are dropped. Returns (the new base, the valid count, the count
    past depth)."""
    depth = out.shape[3]
    shape = valid.shape  # [nz, nyb, R, NLANE]
    v = valid.to(torch.int64)
    rank = base + torch.cumsum(v, dim=2) - v
    put = valid & (rank < depth)
    dev = out.device
    zd = torch.arange(shape[0], device=dev)[:, None, None, None].expand(shape)
    yd = torch.arange(shape[1], device=dev)[None, :, None, None].expand(shape)
    ld = torch.arange(shape[3], device=dev)[None, None, None, :].expand(shape)
    out[:, zd[put], yd[put], rank[put], ld[put]] = vals[:, put]
    return base + v.sum(dim=2, keepdim=True), v.sum(), (valid & (rank >= depth)).sum()


def _sep_pass(spec: GridSpec, w: torch.Tensor, axis: int, depth: int, strag=None):
    """One pass of the separable rebin, fixing cell axis ``axis`` (0 = x,
    1 = y, 2 = z) from the 3 neighbor cells along it: candidates in the
    order -1, 0, +1, source rows ascending, then (z pass) the stragglers,
    claimed by their full cell. Returns (out [Q, nz, nyb, depth, NLANE],
    placed count, overflow count)."""
    n_q = w.shape[0]
    nx, ny, nz = spec.shape
    F, nlane, nyb = spec.fold, spec.nlane, spec.nyb
    Ls = spec.box_size
    dev = w.device
    lane = torch.arange(nlane, device=dev)
    my_c = (
        (lane // F).to(torch.float32)[None, None, None, :],
        (torch.arange(nyb, device=dev)[:, None] * F + lane[None, :] % F)
        .to(torch.float32)[None, :, None, :],
        torch.arange(nz, device=dev).to(torch.float32)[:, None, None, None],
    )
    ncell = (nx, ny, nz)
    rows = torch.arange(w.shape[3], device=dev)[None, None, :, None]
    out = torch.zeros((n_q, nz, nyb, depth, nlane), dtype=torch.float32, device=dev)
    base = torch.zeros((nz, nyb, 1, nlane), dtype=torch.int64, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    over = torch.zeros((), dtype=torch.int64, device=dev)

    def place(cand, valid):
        nonlocal base, count, over
        vals = torch.stack([c.expand(valid.shape) + 0.0 for c in cand])
        base, n, o = _rank_into(out, base, vals, valid)
        count, over = count + n, over + o

    for k in (-1, 0, 1):
        off = [0, 0, 0]
        off[axis] = k  # (dx, dy, dz)
        zs, ybs, ls, _ = stencil_sources(spec, off[2], off[1], off[0], dev)
        cand = list(w[:, zs, ybs, rows, ls])
        cand[axis], c = _wrapped_cell(cand[axis], Ls[axis], ncell[axis])
        valid = (cand[n_q - 1] > 0.5) & (c == my_c[axis])
        place(cand, valid)
    if strag is not None:
        sc = [strag[q][None, None, :, None] for q in range(n_q)]
        valid = sc[n_q - 1] > 0.5
        for d in range(3):
            sc[d], c = _wrapped_cell(sc[d], Ls[d], ncell[d])
            valid = valid & (c == my_c[d])
        place(sc, valid)
    unfilled = torch.arange(depth, device=dev)[None, None, :, None] >= base
    out[:3] = torch.where(unfilled, torch.full_like(out[:3], EMPTY_POS), out[:3])
    return out, count, over


def separable_rebin_plain(spec: GridSpec, stacked: torch.Tensor, strag: torch.Tensor,
                          ocap: int = OCAP):
    """Plain PyTorch version of the three-pass rebin: z (absorbing the
    straggler list), then y, then x, each at the wide capacity CAP + ocap;
    the x pass's ranks CAP .. CAP+ocap-1 form the overflow mini-grid.
    ``stacked`` is [Q, nz, nyb, CAP, NLANE] (x, y, z first, pid+1 last),
    ``strag`` the [Q, S] straggler rows. Returns (out, mini, count,
    overflow): count is the x pass's placed particles, overflow the sum
    over the passes of ranks past the capacity."""
    cap = spec.cap
    wide = cap + ocap
    pad = torch.zeros(stacked.shape[:3] + (ocap, stacked.shape[4]),
                      dtype=stacked.dtype, device=stacked.device)
    pad[:3] = EMPTY_POS
    wz, _, over_z = _sep_pass(spec, torch.cat([stacked, pad], dim=3), 2, wide, strag)
    wy, _, over_y = _sep_pass(spec, wz, 1, wide)
    wx, count, over_x = _sep_pass(spec, wy, 0, wide)
    return (wx[:, :, :, :cap].contiguous(), wx[:, :, :, cap:].contiguous(), count,
            over_z + over_y + over_x)


class SeparableRebinKernel:
    """``rebin(stacked [Q, nz, nyb, CAP, NLANE], strag [Q, S]) -> (out,
    mini, count, overflow)`` for one ``GridSpec`` with ``n_strag > 0``.

    CPU tensors go to ``separable_rebin_plain``; CUDA tensors launch
    ``csrc/sep_rebin.cu`` at Q = 7 or 4 (its classify and pull kernels, one
    count in ``SEP_REBIN.launches`` per call) or raise. Where the plain
    version reports no overflow the two are bit-equal; where it does, only
    ``overflow > 0`` is held equal (the state is latched as invalid).
    ``order`` is 0; a check's control sets 1 (the sources in #3's (dz, dy,
    dx) order) or 2 (the straggler rows ranked last), which must change the
    output."""

    order = 0

    def __init__(self, spec: GridSpec, ocap: int = OCAP):
        if spec.n_strag <= 0:
            raise ValueError("the separable rebin needs a straggler-capable spec")
        self.spec = spec
        self.ocap = ocap
        nx, _, nz = spec.shape
        # the C entry's geometry and box, and where the counts sit in the
        # scratch, made once (the PSE step's host time is its limit)
        self._geom = (spec.n_strag, nx, spec.nyb, nz, spec.fold, spec.cap, ocap)
        self._box = tuple(spec.box_size) + tuple(recip32(L) for L in spec.box_size)
        self._scratch = sep_rebin_launch_plan(spec, ocap)["scratch_bytes"]

    def __call__(self, stacked: torch.Tensor, strag: torch.Tensor):
        spec = self.spec
        if stacked.dim() != 5 or stacked.shape[0] < 4:
            raise ValueError("stacked must be [Q >= 4, nz, nyb, CAP, NLANE]")
        n_q = stacked.shape[0]
        shape = (n_q,) + spec.array_shape
        sshape = (n_q, spec.n_strag)
        if stacked.device.type == "cpu":
            if (stacked.dtype != torch.float32 or tuple(stacked.shape) != shape
                    or tuple(strag.shape) != sshape):
                raise ValueError(f"stacked must be float32 {shape}, strag {sshape}")
            return separable_rebin_plain(spec, stacked, strag, self.ocap)
        if n_q not in (7, 4):
            raise ValueError(f"the separable rebin kernel carries Q = 7 or 4 quantities, "
                             f"not {n_q}")
        _build.check_cuda_tensor(stacked, "stacked", shape)
        strag = strag.contiguous()
        _build.check_cuda_tensor(strag, "strag", sshape)
        dev = stacked.device
        scratch = torch.empty(self._scratch, dtype=torch.uint8, device=dev)
        counts = scratch[self._scratch - 8:].view(torch.int32)
        out = torch.empty_like(stacked)
        mini = torch.empty((n_q,) + spec.array_shape[:2] + (self.ocap, spec.nlane),
                           dtype=torch.float32, device=dev)
        P = _build.ptr
        SEP_REBIN(P(stacked), P(strag), P(scratch), P(out), P(mini), n_q, *self._geom,
                  int(self.order), *self._box)
        return out, mini, counts[0], counts[1]


def make_separable_rebin(spec: GridSpec, ocap: int = OCAP) -> SeparableRebinKernel:
    """Build the three-pass straggler-aware rebin for one spec."""
    return SeparableRebinKernel(spec, ocap)


# uammd_rebin2(in, strag, scratch, out, mini, Q, S, nx, nyb, nz, F, cap, ocap,
#              Lx, Ly, Lz, 1/Lx, 1/Ly, 1/Lz, stream)
REBIN2 = _build.Kernel("rebin2", "uammd_rebin2", [_P] * 5 + [_I] * 8 + [_F] * 6)

# The launch of ``csrc/rebin2.cu`` is #5's: the same classify kernel and
# rows of blocks, a pull of the same threads, shared memory and scratch.
rebin2_launch_plan = sep_rebin_launch_plan


def rebin2_plain(spec: GridSpec, stacked: torch.Tensor, strag: torch.Tensor,
                 ocap: int = OCAP):
    """Plain PyTorch version of the one-shot straggler-aware rebin (#4):
    every cell ranks its candidates from the 27 neighbor cells in the
    kernel's order (dz, dy, dx, source slots ascending), then the straggler
    rows ``strag`` [Q, S] in order, by an exclusive cumsum per cell; ranks
    below CAP go to ``out``, CAP .. CAP+ocap-1 to the mini-grid. Returns
    (out, mini, count of valid candidates, count of ranks past CAP + ocap)."""
    n_q = stacked.shape[0]
    nx, ny, nz = spec.shape
    F, cap, nlane, nyb = spec.fold, spec.cap, spec.nlane, spec.nyb
    Ls = spec.box_size
    ncell = (nx, ny, nz)
    wide = cap + ocap
    dev = stacked.device
    lane = torch.arange(nlane, device=dev)
    my_c = (
        (lane // F).to(torch.float32)[None, None, None, :],
        (torch.arange(nyb, device=dev)[:, None] * F + lane[None, :] % F)
        .to(torch.float32)[None, :, None, :],
        torch.arange(nz, device=dev).to(torch.float32)[:, None, None, None],
    )
    rows = torch.arange(cap, device=dev)[None, None, :, None]
    out = torch.zeros((n_q, nz, nyb, wide, nlane), dtype=torch.float32, device=dev)
    base = torch.zeros((nz, nyb, 1, nlane), dtype=torch.int64, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    over = torch.zeros((), dtype=torch.int64, device=dev)

    def place(pos, rest):
        nonlocal base, count, over
        valid = rest[-1] > 0.5
        wrapped = []
        for d in range(3):
            w, c = _wrapped_cell(pos[d], Ls[d], ncell[d])
            wrapped.append(w)
            valid = valid & (c == my_c[d])
        shape = valid.shape
        vals = torch.stack([w.expand(shape) for w in wrapped]
                           + [c.expand(shape) + 0.0 for c in rest])
        base, n, o = _rank_into(out, base, vals, valid)
        count, over = count + n, over + o

    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zs, ybs, ls, _ = stencil_sources(spec, dz, dy, dx, dev)
                cand = stacked[:, zs, ybs, rows, ls]  # [Q, nz, nyb, cap, nlane]
                place(list(cand[:3]), list(cand[3:]))
    sc = [strag[q][None, None, :, None] for q in range(n_q)]
    place(sc[:3], sc[3:])
    unfilled = torch.arange(wide, device=dev)[None, None, :, None] >= base
    out[:3] = torch.where(unfilled, torch.full_like(out[:3], EMPTY_POS), out[:3])
    return (out[:, :, :, :cap].contiguous(), out[:, :, :, cap:].contiguous(), count, over)


class RebinKernel2:
    """``rebin(stacked [Q, nz, nyb, CAP, NLANE], strag) -> (out, mini,
    count, overflow)`` for one ``GridSpec`` with ``n_strag > 0``; ``strag``
    is the [Q, S] straggler rows or the JAX kernel's broadcast [Q, S,
    NLANE] block of them (its first lane is read).

    CPU tensors go to ``rebin2_plain``; CUDA tensors launch
    ``csrc/rebin2.cu`` at Q = 7 or 4 (its classify and pull kernels, one
    count in ``REBIN2.launches`` per call) or raise. The two are bit-equal,
    counts included."""

    def __init__(self, spec: GridSpec, ocap: int = OCAP):
        if spec.n_strag <= 0:
            raise ValueError("the one-shot straggler rebin needs a straggler-capable spec")
        self.spec = spec
        self.ocap = ocap
        nx, _, nz = spec.shape
        self._geom = (spec.n_strag, nx, spec.nyb, nz, spec.fold, spec.cap, ocap)
        self._box = tuple(spec.box_size) + tuple(recip32(L) for L in spec.box_size)
        self._scratch = rebin2_launch_plan(spec, ocap)["scratch_bytes"]

    def __call__(self, stacked: torch.Tensor, strag: torch.Tensor):
        spec = self.spec
        if stacked.dim() != 5 or stacked.shape[0] < 4:
            raise ValueError("stacked must be [Q >= 4, nz, nyb, CAP, NLANE]")
        n_q = stacked.shape[0]
        shape = (n_q,) + spec.array_shape
        if strag.dim() == 3:
            if tuple(strag.shape) != (n_q, spec.n_strag, spec.nlane):
                raise ValueError(f"the straggler block must be {(n_q, spec.n_strag, spec.nlane)}")
            strag = strag[:, :, 0]
        sshape = (n_q, spec.n_strag)
        if stacked.device.type == "cpu":
            if (stacked.dtype != torch.float32 or tuple(stacked.shape) != shape
                    or strag.dtype != torch.float32 or tuple(strag.shape) != sshape):
                raise ValueError(f"stacked must be float32 {shape}, strag {sshape}")
            return rebin2_plain(spec, stacked, strag, self.ocap)
        if n_q not in (7, 4):
            raise ValueError(f"the one-shot rebin kernel carries Q = 7 or 4 quantities, "
                             f"not {n_q}")
        if min(spec.shape) < 3:
            raise ValueError(f"the one-shot rebin kernel needs 3 cells or more an axis, "
                             f"not {tuple(spec.shape)}")
        _build.check_cuda_tensor(stacked, "stacked", shape)
        strag = strag.contiguous()
        _build.check_cuda_tensor(strag, "strag", sshape)
        dev = stacked.device
        scratch = torch.empty(self._scratch, dtype=torch.uint8, device=dev)
        counts = scratch[self._scratch - 8:].view(torch.int32)
        out = torch.empty_like(stacked)
        mini = torch.empty((n_q,) + spec.array_shape[:2] + (self.ocap, spec.nlane),
                           dtype=torch.float32, device=dev)
        P = _build.ptr
        REBIN2(P(stacked), P(strag), P(scratch), P(out), P(mini), n_q, *self._geom, *self._box)
        return out, mini, counts[0], counts[1]


def make_rebin_kernel2(spec: GridSpec, ocap: int = OCAP) -> RebinKernel2:
    """Build the one-shot straggler-aware rebin for one spec."""
    return RebinKernel2(spec, ocap)


def _compact_mini(mini: torch.Tensor, S: int):
    """[Q, nz, nyb, OCAP, NLANE] overflow mini-grid -> the dense [S]
    straggler rows: the occupied entries in flat index order, the first S
    of them (JAX's ``top_k`` of the 0/1 mask returns ties in index order;
    a cumsum rank gives that order without a host sync). Returns (spos
    [S, 3], svel [S, 3], spid [S], occupied count)."""
    n_q = mini.shape[0]
    cols = mini.reshape(n_q, -1)
    mask = cols[n_q - 1] > 0.5
    count = mask.sum()
    rank = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    take = mask & (rank < S)
    # entries not taken all go to the dump row S, which is dropped
    target = torch.where(take, rank, torch.full_like(rank, S))
    dense = torch.zeros((n_q, S + 1), dtype=torch.float32, device=mini.device)
    filled = torch.zeros(S + 1, dtype=torch.bool, device=mini.device)
    dense[:, target] = cols
    filled[target] = take
    dense, filled = dense[:, :S], filled[:S]
    spos = torch.stack([torch.where(filled, dense[d], EMPTY_POS) for d in range(3)], dim=-1)
    svel = torch.stack([torch.where(filled, dense[3 + d], 0.0) for d in range(3)], dim=-1)
    spid = torch.where(filled, dense[n_q - 1].to(torch.int32) - 1, -1)
    return spos, svel, spid.to(torch.int32), count


def compact_mini_pids(mini: torch.Tensor, S: int):
    """[Q, nz, nyb, ocap, NLANE] overflow mini-grid -> the dense [S]
    straggler pids (int32, -1 = empty) and the occupied count: the pid-only
    form of ``_compact_mini``, for callers that gather positions by pid
    afterwards (the PSE persistent refresh). The JAX package takes
    ``top_k`` of the 0/1 mask (ties in index order); the same cumsum rank
    as ``_compact_mini`` gives that order without a host sync."""
    pidf = mini[mini.shape[0] - 1].reshape(-1)
    mask = pidf > 0.5
    count = mask.sum()
    rank = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    take = mask & (rank < S)
    # entries not taken all go to the dump row S, which is dropped
    target = torch.where(take, rank, torch.full_like(rank, S))
    dense = torch.full((S + 1,), -1, dtype=torch.int32, device=mini.device)
    dense.scatter_(0, target, torch.where(take, pidf.to(torch.int32) - 1, -1).to(torch.int32))
    return dense[:S], count

def _strag_rebin(gs: GridState, kernel) -> GridState:
    """A straggler-aware rebin of (pos, vel, pid) through ``kernel``
    (stacked, strag rows) -> (out, mini, count, overflow): re-absorbs the
    straggler list into cells, emits the new overflow set as the next
    straggler list and drops forces (the v2 engine recomputes them right
    after). Latches overflow on any rank past a capacity, a particle lost
    (moved more than one cell) or more than S stragglers."""
    S = gs.spec.n_strag
    stacked = torch.stack([gs.x, gs.y, gs.z, gs.vx, gs.vy, gs.vz,
                           (gs.pid + 1).to(torch.float32)])
    strag = torch.stack([gs.spos[:, 0], gs.spos[:, 1], gs.spos[:, 2],
                         gs.svel[:, 0], gs.svel[:, 1], gs.svel[:, 2],
                         (gs.spid + 1).to(torch.float32)])
    out, mini, count, ovf = kernel(stacked, strag)
    pid = out[6].to(torch.int32) - 1
    spos, svel, spid, s_count = _compact_mini(mini, S)
    overflow = gs.overflow | (ovf > 0) | (count != gs.n) | (s_count > S)
    zero = torch.zeros_like(gs.fx)
    return gs.replace(
        x=out[0], y=out[1], z=out[2],
        vx=out[3], vy=out[4], vz=out[5],
        fx=zero, fy=zero, fz=zero,
        pid=pid, ref_x=out[0], ref_y=out[1], ref_z=out[2],
        overflow=overflow,
        spos=spos, svel=svel, sforce=torch.zeros_like(gs.sforce), spid=spid,
    )


def rebin_fast3(gs: GridState) -> GridState:
    """Straggler-aware rebin through the separable kernel (#5)."""
    return _strag_rebin(gs, SeparableRebinKernel(gs.spec))


def rebin_fast2(gs: GridState) -> GridState:
    """Straggler-aware rebin through the one-shot kernel (#4)."""
    return _strag_rebin(gs, RebinKernel2(gs.spec))


def rebin_fast_noforce(gs: GridState) -> GridState:
    """Rebin carrying only (pos, vel, pid) (Q = 7); forces come back zero.
    Valid whenever forces are recomputed right after, as the
    Gronbech-Jensen step does."""
    out, pid, overflow = _rebin_quantities(
        gs, (gs.x, gs.y, gs.z, gs.vx, gs.vy, gs.vz))
    zero = torch.zeros_like(gs.fx)
    return gs.replace(
        x=out[0], y=out[1], z=out[2],
        vx=out[3], vy=out[4], vz=out[5],
        fx=zero, fy=zero, fz=zero,
        pid=pid, ref_x=out[0], ref_y=out[1], ref_z=out[2],
        overflow=overflow,
    )

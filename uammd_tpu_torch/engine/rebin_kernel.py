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
The call returns ``(out, count, overflow)``: the number of particles found
and the number ranked past CAP. The caller latches overflow when
``overflow > 0`` or ``count != n`` (a particle moved more than one cell).

On CUDA tensors the wrapper launches ``csrc/rebin.cu``; on CPU tensors it
runs ``rebin_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .layout import EMPTY_POS, GridSpec, GridState, recip32, stencil_sources

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p

# uammd_rebin(in, out, counts, Q, nx, nyb, nz, F, cap, Lx, Ly, Lz,
#             1/Lx, 1/Ly, 1/Lz, stream)
REBIN = _build.Kernel("rebin", "uammd_rebin", [_P] * 3 + [_I] * 6 + [_F] * 6)


def _dest_cell(p, L, n):
    # floor((p/L + 0.5 - floor(p/L + 0.5)) * n); p/L as the TPU kernel
    # computes it after XLA's rewrite, p * float32(1/L)
    fr = p * recip32(L) + 0.5
    return torch.floor((fr - torch.floor(fr)) * float(n))


def _wrap_pos(p, L):
    return (p - L * torch.round(p * recip32(L))) + 0.0


def rebin_plain(spec: GridSpec, stacked: torch.Tensor):
    """Plain PyTorch version of the kernel: the 27 candidate cells are
    visited in the kernel's order and each candidate's rank is the running
    count of valid candidates before it (an exclusive cumsum per cell)."""
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
                zs, ybs, ls, (shx, shy, shz) = stencil_sources(spec, dz, dy, dx, dev)
                cand = stacked[:, zs, ybs, rows, ls]  # [Q, nz, nyb, cap, nlane]
                px, py, pz = cand[0] + shx, cand[1] + shy, cand[2] + shz
                valid = (
                    (cand[n_q - 1] > 0.5)
                    & (_dest_cell(px, Lx, nx) == my_cx)
                    & (_dest_cell(py, Ly, ny) == my_cy)
                    & (_dest_cell(pz, Lz, nz) == my_cz)
                )
                v = valid.to(torch.int64)
                rank = base + torch.cumsum(v, dim=2) - v
                base = base + v.sum(dim=2, keepdim=True)
                count = count + v.sum()
                over = over + (valid & (rank >= cap)).sum()
                place = valid & (rank < cap)
                vals = torch.stack(
                    [_wrap_pos(px, Lx), _wrap_pos(py, Ly), _wrap_pos(pz, Lz)]
                    + [cand[q] + 0.0 for q in range(3, n_q)]
                )
                out[:, zd[place], yd[place], rank[place], ld[place]] = vals[:, place]
    unfilled = rows >= base  # [nz, nyb, cap, nlane]
    out[:3] = torch.where(unfilled, torch.full_like(out[:3], EMPTY_POS), out[:3])
    return out, count, over


class RebinKernel:
    """``rebin_stacked(stacked [Q, nz, nyb, CAP, NLANE]) -> (out, count,
    overflow)`` for one ``GridSpec``; Q is read from the input.

    CPU tensors go to ``rebin_plain``; CUDA tensors launch ``csrc/rebin.cu``
    (counted in ``REBIN.launches``) or raise."""

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
        _build.check_cuda_tensor(stacked, "stacked", shape)
        nx, _, nz = spec.shape
        Lx, Ly, Lz = spec.box_size
        out = torch.empty_like(stacked)
        counts = torch.zeros(2, dtype=torch.int32, device=stacked.device)
        P = _build.ptr
        REBIN(
            P(stacked), P(out), P(counts), shape[0],
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

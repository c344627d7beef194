// One-shot straggler-aware rebin of the grid-resident layout, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/rebin_kernel.py:make_rebin_kernel2
// (pallas_call at :522; kernel body :338-491), which carries rebin_fast2.
// Quantities travel stacked as [Q, nz, nyb, CAP, NLANE] float32 with x, y, z
// first and pid+1 last (0 on empty slots); the straggler rows as [Q, S] (the
// JAX kernel's broadcast [Q, S, NLANE] block, one lane of it). Each
// destination cell pulls the particles whose position falls in it from its
// 27-cell neighborhood (one cell of drift at most, the half-slack trigger
// guarantees it) and from the whole straggler list (stragglers are global,
// so the one-cell guarantee does not hold for them).
//
// Order and overflow rule (JAX's): each cell ranks its candidates from the
// 27 source cells in the order dz, dy, dx (each -1, 0, 1), source slots
// ascending, then the straggler rows in order. Ranks below CAP go to `out`,
// ranks CAP .. CAP+OCAP-1 to the overflow mini-grid `mini` [Q, nz, nyb,
// OCAP, NLANE] (the next straggler set, compacted outside), and ranks past
// CAP+OCAP are counted as overflow. Every valid candidate is counted, so the
// caller also flags count != n (a particle moved more than one cell).
//
// Design: one block per (z, yb) column, one thread per destination cell
// (lane); the straggler rows are staged in shared memory. Each thread visits
// its candidates in the order above and keeps a running rank. The kernel
// moves values and never does arithmetic on them: positions are wrapped
// into the primary box with p - L rint(p (1/L)) and the rest pass as 0 + v
// (as the TPU kernel's one-hot sums give them, so -0 becomes +0), so the
// output equals its plain version bit for bit. A candidate belongs to the
// cell of its wrapped coordinate (no image shift: the sort rebin's rule,
// layout.rebin; the TPU kernel tests the shifted coordinate before it
// wraps, which near +-L/2 can lose a particle). Cells use the float32
// reciprocal of L (layout.recip32), as XLA computes the TPU kernel's
// division by a constant, with every operation an explicit
// round-to-nearest intrinsic.
// Unfilled slots of `out` and `mini` get EMPTY_POS on x, y, z and 0
// elsewhere. The counts go into counts[0] (valid candidates) and counts[1]
// (ranks past CAP + OCAP) with integer atomics.
//
// What bounds it: memory. It reads the Q input planes and writes the Q
// output planes and the mini-grid once; the 27-fold candidate reads hit
// L1/L2.

#include <cuda_runtime.h>

namespace {

constexpr float kEmptyPos = 1.0e9f;

struct Geom {
  int nx, nyb, nz, F, cap, ocap, nlane;
  float Lx, Ly, Lz;
  float iLx, iLy, iLz;  // float32 reciprocals of the box lengths
};

__device__ __forceinline__ int wrap_index(int s, int n) {
  return s < 0 ? s + n : (s >= n ? s - n : s);
}

// floor((p/L + 0.5 - floor(p/L + 0.5)) * n), as the TPU kernel computes it.
__device__ __forceinline__ float dest_cell(float p, float iL, float n) {
  const float fr = __fadd_rn(__fmul_rn(p, iL), 0.5f);
  return floorf(__fmul_rn(__fsub_rn(fr, floorf(fr)), n));
}

// 0 + (p - L*round(p/L)) with round-half-to-even (jnp.round).
__device__ __forceinline__ float wrap_pos(float p, float L, float iL) {
  return __fadd_rn(0.0f, __fsub_rn(p, __fmul_rn(L, rintf(__fmul_rn(p, iL)))));
}

struct Dest {
  float* out;    // [Q, nz, nyb, cap, nlane]
  float* mini;   // [Q, nz, nyb, ocap, nlane]
  size_t qout, qmini;  // per-quantity strides
  size_t dout, dmini;  // this cell's row-0 offsets
};

// Writes candidate values at `rank` (px, py, pz already wrapped): to out,
// to mini, or nowhere (overflow).
__device__ __forceinline__ void put(const Dest& d, const Geom& g, int Q, int rank,
                                    float px, float py, float pz, const float* rest,
                                    size_t rest_stride) {
  float* base;
  size_t qs;
  if (rank < g.cap) {
    base = d.out + d.dout + static_cast<size_t>(rank) * g.nlane;
    qs = d.qout;
  } else {
    base = d.mini + d.dmini + static_cast<size_t>(rank - g.cap) * g.nlane;
    qs = d.qmini;
  }
  base[0] = px;
  base[qs] = py;
  base[2 * qs] = pz;
  for (int q = 3; q < Q; ++q) base[q * qs] = __fadd_rn(0.0f, rest[(q - 3) * rest_stride]);
}

__global__ void rebin2_kernel(const float* __restrict__ in, const float* __restrict__ strag,
                              float* __restrict__ out, float* __restrict__ mini,
                              int* __restrict__ counts, int Q, int S, Geom g) {
  extern __shared__ float srows[];  // [Q, S]
  const int yb = blockIdx.x;
  const int zc = blockIdx.y;
  const int lane = threadIdx.x;
  for (int e = threadIdx.x; e < Q * S; e += blockDim.x) srows[e] = strag[e];
  __syncthreads();

  int n_valid = 0;
  int n_over = 0;
  if (lane < g.nlane) {
    const int cx = lane / g.F;
    const int f = lane - cx * g.F;
    const int ny = g.nyb * g.F;
    const int cy = yb * g.F + f;
    const float my_cx = static_cast<float>(cx);
    const float my_cy = static_cast<float>(cy);
    const float my_cz = static_cast<float>(zc);
    const float fnx = static_cast<float>(g.nx);
    const float fny = static_cast<float>(ny);
    const float fnz = static_cast<float>(g.nz);
    const int wide = g.cap + g.ocap;
    const size_t plane = static_cast<size_t>(g.cap) * g.nlane;
    const size_t qstride = static_cast<size_t>(g.nz) * g.nyb * plane;
    const size_t zyb = static_cast<size_t>(zc) * g.nyb + yb;
    const Dest d{out, mini, qstride, static_cast<size_t>(g.nz) * g.nyb * g.ocap * g.nlane,
                 zyb * plane + lane, zyb * g.ocap * g.nlane + lane};
    const float* pid_in = in + static_cast<size_t>(Q - 1) * qstride;

    for (int dz = -1; dz <= 1; ++dz) {
      const int sz = wrap_index(zc + dz, g.nz);
      for (int dy = -1; dy <= 1; ++dy) {
        const int sy = wrap_index(cy + dy, ny);
        const int syb = sy / g.F;
        const int sf = sy - syb * g.F;
        for (int dx = -1; dx <= 1; ++dx) {
          const int sx = wrap_index(cx + dx, g.nx);
          const size_t src0 = (static_cast<size_t>(sz) * g.nyb + syb) * plane + sx * g.F + sf;
          for (int j = 0; j < g.cap; ++j) {
            const size_t s = src0 + static_cast<size_t>(j) * g.nlane;
            if (!(pid_in[s] > 0.5f)) continue;  // pid travels as pid+1
            const float px = wrap_pos(in[s], g.Lx, g.iLx);
            const float py = wrap_pos(in[qstride + s], g.Ly, g.iLy);
            const float pz = wrap_pos(in[2 * qstride + s], g.Lz, g.iLz);
            if (dest_cell(px, g.iLx, fnx) != my_cx || dest_cell(py, g.iLy, fny) != my_cy ||
                dest_cell(pz, g.iLz, fnz) != my_cz)
              continue;
            const int rank = n_valid++;
            if (rank >= wide) {
              ++n_over;
              continue;
            }
            put(d, g, Q, rank, px, py, pz, in + 3 * qstride + s, qstride);
          }
        }
      }
    }
    // the straggler rows: global candidates, wrapped as the grid's
    for (int s = 0; s < S; ++s) {
      if (!(srows[(Q - 1) * S + s] > 0.5f)) continue;
      const float px = wrap_pos(srows[s], g.Lx, g.iLx);
      const float py = wrap_pos(srows[S + s], g.Ly, g.iLy);
      const float pz = wrap_pos(srows[2 * S + s], g.Lz, g.iLz);
      if (dest_cell(px, g.iLx, fnx) != my_cx || dest_cell(py, g.iLy, fny) != my_cy ||
          dest_cell(pz, g.iLz, fnz) != my_cz)
        continue;
      const int rank = n_valid++;
      if (rank >= wide) {
        ++n_over;
        continue;
      }
      put(d, g, Q, rank, px, py, pz, srows + 3 * S + s, S);
    }
    for (int r = min(n_valid, wide); r < wide; ++r) {
      float* base;
      size_t qs;
      if (r < g.cap) {
        base = out + d.dout + static_cast<size_t>(r) * g.nlane;
        qs = d.qout;
      } else {
        base = mini + d.dmini + static_cast<size_t>(r - g.cap) * g.nlane;
        qs = d.qmini;
      }
      base[0] = kEmptyPos;
      base[qs] = kEmptyPos;
      base[2 * qs] = kEmptyPos;
      for (int q = 3; q < Q; ++q) base[q * qs] = 0.0f;
    }
  }
  // every lane of the warp reaches here (the block is whole warps)
  n_valid = __reduce_add_sync(0xffffffffu, n_valid);
  n_over = __reduce_add_sync(0xffffffffu, n_over);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&counts[0], n_valid);
    atomicAdd(&counts[1], n_over);
  }
}

}  // namespace

// in: [Q, nz, nyb, cap, nlane]; strag: [Q, S] (S may be 0, strag then
// unread); out: like in; mini: [Q, nz, nyb, ocap, nlane]; counts: int32[2],
// zeroed by the caller -> (valid candidates, ranks past cap + ocap).
extern "C" int uammd_rebin2(void* in, void* strag, void* out, void* mini, void* counts, int Q,
                            int S, int nx, int nyb, int nz, int F, int cap, int ocap, float Lx,
                            float Ly, float Lz, float iLx, float iLy, float iLz,
                            void* stream) {
  const Geom g{nx, nyb, nz, F, cap, ocap, nx * F, Lx, Ly, Lz, iLx, iLy, iLz};
  const int threads = (g.nlane + 31) / 32 * 32;
  const dim3 grid(nyb, nz);
  const size_t smem = sizeof(float) * static_cast<size_t>(Q) * S;
  rebin2_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(strag),
      static_cast<float*>(out), static_cast<float*>(mini), static_cast<int*>(counts), Q, S,
      g);
  return static_cast<int>(cudaGetLastError());
}

// One-shot pull rebin of the grid-resident layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/rebin_kernel.py:make_rebin_kernel
// (pallas_call at :223; kernel body :68-190). Quantities travel stacked as
// [Q, nz, nyb, CAP, NLANE] float32 with x, y, z first and pid+1 last (0 on
// empty slots). Particles move at most one cell between rebins (the drift
// trigger guarantees it), so each destination cell pulls its particles from
// its 27-cell neighborhood.
//
// Design: one thread per destination cell. It visits the 27 source cells in
// the TPU kernel's order (dz, then dy, then dx, each in -1, 0, 1) and each
// cell's slots in ascending order, so candidates land at the same ranks as
// the TPU kernel's prefix-count compaction and the output equals it slot
// for slot and bit for bit. The image shift is added only on an axis whose
// index wrapped. p/L is p * (1/L) with the float32 reciprocal passed in,
// because XLA folds the TPU kernel's division by a constant into exactly
// that multiply. Every float operation that decides a destination cell or
// a wrapped position is an explicit round-to-nearest intrinsic (__fmul_rn,
// __fadd_rn, ...) so nvcc cannot contract it into an FMA. Unfilled slots
// get EMPTY_POS on x/y/z and 0 elsewhere; values pass as 0 + v, as the TPU
// kernel's one-hot sums do (so -0 becomes +0). Valid candidates and ranks
// >= CAP are counted with integer atomics (exact) into counts[0], counts[1].
//
// What bounds it: memory. The work is O(slots) and the kernel moves each of
// the Q input and Q output planes once (2 x 7 x 8.6 MB at the 2^20 spec);
// the 27-fold candidate reads hit L1/L2.

#include <cuda_runtime.h>

namespace {

constexpr float kEmptyPos = 1.0e9f;

struct Geom {
  int nx, nyb, nz, F, cap, nlane;
  float Lx, Ly, Lz;
  float iLx, iLy, iLz;  // float32 reciprocals of the box lengths
};

__device__ __forceinline__ int wrap_index(int s, int n, float L, float* shift) {
  if (s < 0) { *shift = -L; return s + n; }
  if (s >= n) { *shift = L; return s - n; }
  *shift = 0.0f;
  return s;
}

// floor((p/L + 0.5 - floor(p/L + 0.5)) * n), as the TPU kernel computes it.
__device__ __forceinline__ float dest_cell(float p, float iL, float n) {
  const float fr = __fadd_rn(__fmul_rn(p, iL), 0.5f);
  return floorf(__fmul_rn(__fsub_rn(fr, floorf(fr)), n));
}

// p - L*round(p/L) with round-half-to-even (jnp.round).
__device__ __forceinline__ float wrap_pos(float p, float L, float iL) {
  return __fadd_rn(0.0f, __fsub_rn(p, __fmul_rn(L, rintf(__fmul_rn(p, iL)))));
}

__global__ void rebin_kernel(const float* __restrict__ in,
                             float* __restrict__ out, int* __restrict__ counts,
                             int Q, Geom g) {
  const int ncell = g.nz * g.nyb * g.nlane;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  int n_valid = 0;
  int n_over = 0;
  if (cell < ncell) {
    const int lane = cell % g.nlane;
    const int zyb = cell / g.nlane;
    const int yb = zyb % g.nyb;
    const int zc = zyb / g.nyb;
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
    const size_t plane = static_cast<size_t>(g.cap) * g.nlane;
    const size_t qstride = static_cast<size_t>(g.nz) * g.nyb * plane;
    const size_t dst0 = static_cast<size_t>(zyb) * plane + lane;
    const float* pid_in = in + static_cast<size_t>(Q - 1) * qstride;

    for (int dz = -1; dz <= 1; ++dz) {
      float shz;
      const int sz = wrap_index(zc + dz, g.nz, g.Lz, &shz);
      for (int dy = -1; dy <= 1; ++dy) {
        float shy;
        const int sy = wrap_index(cy + dy, ny, g.Ly, &shy);
        const int syb = sy / g.F;
        const int sf = sy - syb * g.F;
        for (int dx = -1; dx <= 1; ++dx) {
          float shx;
          const int sx = wrap_index(cx + dx, g.nx, g.Lx, &shx);
          const size_t src0 = (static_cast<size_t>(sz) * g.nyb + syb) * plane + sx * g.F + sf;
          for (int j = 0; j < g.cap; ++j) {
            const size_t s = src0 + static_cast<size_t>(j) * g.nlane;
            if (!(pid_in[s] > 0.5f)) continue;  // pid travels as pid+1
            float px = in[s];
            float py = in[qstride + s];
            float pz = in[2 * qstride + s];
            if (shx != 0.0f) px = __fadd_rn(px, shx);
            if (shy != 0.0f) py = __fadd_rn(py, shy);
            if (shz != 0.0f) pz = __fadd_rn(pz, shz);
            if (dest_cell(px, g.iLx, fnx) != my_cx || dest_cell(py, g.iLy, fny) != my_cy ||
                dest_cell(pz, g.iLz, fnz) != my_cz)
              continue;
            const int rank = n_valid++;
            if (rank >= g.cap) {
              ++n_over;
              continue;
            }
            const size_t d = dst0 + static_cast<size_t>(rank) * g.nlane;
            out[d] = wrap_pos(px, g.Lx, g.iLx);
            out[qstride + d] = wrap_pos(py, g.Ly, g.iLy);
            out[2 * qstride + d] = wrap_pos(pz, g.Lz, g.iLz);
            for (int q = 3; q < Q; ++q)
              out[q * qstride + d] = __fadd_rn(0.0f, in[q * qstride + s]);
          }
        }
      }
    }
    for (int r = min(n_valid, g.cap); r < g.cap; ++r) {
      const size_t d = dst0 + static_cast<size_t>(r) * g.nlane;
      out[d] = kEmptyPos;
      out[qstride + d] = kEmptyPos;
      out[2 * qstride + d] = kEmptyPos;
      for (int q = 3; q < Q; ++q) out[q * qstride + d] = 0.0f;
    }
  }
  // every lane of the warp reaches here (no early return)
  n_valid = __reduce_add_sync(0xffffffffu, n_valid);
  n_over = __reduce_add_sync(0xffffffffu, n_over);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&counts[0], n_valid);
    atomicAdd(&counts[1], n_over);
  }
}

}  // namespace

// counts: int32[2], zeroed by the caller -> (valid candidates, overflowed).
extern "C" int uammd_rebin(void* in, void* out, void* counts, int Q, int nx,
                           int nyb, int nz, int F, int cap, float Lx,
                           float Ly, float Lz, float iLx, float iLy,
                           float iLz, void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, iLx, iLy, iLz};
  const int ncell = nz * nyb * g.nlane;
  const int threads = 128;
  const int blocks = (ncell + threads - 1) / threads;
  rebin_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<int*>(counts), Q, g);
  return static_cast<int>(cudaGetLastError());
}

// Separable three-pass rebin with straggler rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/rebin_kernel.py:
// make_separable_rebin (pallas_calls at :904, :920, :934 over _sep_place,
// :626, and the widening at :952). Quantities travel stacked as
// [Q, nz, nyb, rows, NLANE] float32 with x, y, z first and pid+1 last.
// Each pass fixes one cell axis, z then y then x, pulling into every
// destination cell the particles of its 3 neighbours along that axis whose
// wrapped coordinate falls in it (the coordinate as stored, wrapped with no
// image shift: the sort rebin's rule, layout.rebin; the TPU kernel wraps
// the image-shifted coordinate, which near +-L/2 stores another
// representative or, one ulp below +L/2 in cell 0, loses the particle).
// The intermediates have the wide capacity
// CAP + OCAP, so a particle in the right z but the wrong x, y cannot
// overflow early. The z pass reads the CAP-row input directly (the JAX
// kernel's empty pad rows can never be claimed) and, last, absorbs the
// straggler rows [Q, S], each claimed by its full target cell. The x pass
// writes ranks < CAP to the output grid and ranks CAP .. CAP+OCAP-1 to the
// overflow mini-grid [Q, nz, nyb, OCAP, NLANE].
//
// Design: one thread per destination cell and pass. It walks the candidate
// cells in the order -1, 0, +1 along the pass's axis and each one's rows
// ascending (then the stragglers), so ranks follow _sep_place's prefix
// counts and the output equals the TPU kernel slot for slot off the faces. As in
// rebin.cu: p/L is p * (1/L) with the float32 reciprocal (XLA's rewrite
// of the TPU kernel's division by a constant), every float operation that
// decides a cell or a wrapped coordinate is an explicit round-to-nearest
// intrinsic, values pass as 0 + v (the one-hot sums' -0 -> +0), and
// unfilled rows get EMPTY_POS on x, y, z and 0 elsewhere. counts[0] gets
// the x pass's claimed candidates, counts[1] the ranks past the capacity
// of all three passes (integer atomics after a warp sum).
//
// What bounds it: memory. The function reads Q input grids and writes Q
// output grids plus the mini-grid; the three passes move 3 x 2 x Q grids
// of the wide capacity.

#include <cuda_runtime.h>

namespace {

constexpr float kEmptyPos = 1.0e9f;

struct Geom {
  int nx, nyb, nz, F, cap, nlane;
  float L[3];   // box lengths x, y, z
  float iL[3];  // their float32 reciprocals
};

__device__ __forceinline__ float dest_cell(float p, float iL, float n) {
  const float fr = __fadd_rn(__fmul_rn(p, iL), 0.5f);
  return floorf(__fmul_rn(__fsub_rn(fr, floorf(fr)), n));
}

__device__ __forceinline__ float wrap_pos(float p, float L, float iL) {
  return __fadd_rn(0.0f, __fsub_rn(p, __fmul_rn(L, rintf(__fmul_rn(p, iL)))));
}

// AXIS: 0 = x, 1 = y, 2 = z. in: [Q, nz, nyb, in_rows, nlane];
// out: ranks < split (out_rows = split); mini: ranks split .. depth-1
// (null when split == depth).
template <int AXIS>
__global__ void sep_pass(const float* __restrict__ in, int in_rows,
                         const float* __restrict__ strag, int S,
                         float* __restrict__ out, float* __restrict__ mini, int split,
                         int depth, int* __restrict__ counts, int Q, Geom g) {
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
    const int my[3] = {cx, cy, zc};
    const int nc[3] = {g.nx, ny, g.nz};
    const float L = g.L[AXIS], iL = g.iL[AXIS];
    const float fn = static_cast<float>(nc[AXIS]);
    const float my_c = static_cast<float>(my[AXIS]);
    const size_t in_plane = static_cast<size_t>(in_rows) * g.nlane;
    const size_t in_q = static_cast<size_t>(g.nz) * g.nyb * in_plane;
    const size_t out_q = static_cast<size_t>(g.nz) * g.nyb * split * g.nlane;
    const int mrows = depth - split;
    const size_t mini_q = static_cast<size_t>(g.nz) * g.nyb * mrows * g.nlane;
    const size_t out0 = static_cast<size_t>(zyb) * split * g.nlane + lane;
    const size_t mini0 = static_cast<size_t>(zyb) * mrows * g.nlane + lane;

    // write quantity q of rank r; pos = the wrapped coordinates (AXIS only,
    // or all three for a straggler)
    auto put = [&](int r, int q, float v) {
      if (r < split)
        out[q * out_q + out0 + static_cast<size_t>(r) * g.nlane] = v;
      else
        mini[q * mini_q + mini0 + static_cast<size_t>(r - split) * g.nlane] = v;
    };

    for (int k = -1; k <= 1; ++k) {
      int sc = my[AXIS] + k;
      if (sc < 0) sc += nc[AXIS];
      if (sc >= nc[AXIS]) sc -= nc[AXIS];
      int sz = zc, syb = yb, sl = lane;
      if (AXIS == 2) sz = sc;
      if (AXIS == 1) { syb = sc / g.F; sl = cx * g.F + (sc - syb * g.F); }
      if (AXIS == 0) sl = sc * g.F + f;
      const size_t src0 = (static_cast<size_t>(sz) * g.nyb + syb) * in_plane + sl;
      for (int j = 0; j < in_rows; ++j) {
        const size_t s = src0 + static_cast<size_t>(j) * g.nlane;
        if (!(in[(Q - 1) * in_q + s] > 0.5f)) continue;  // pid travels as pid+1
        const float p = wrap_pos(in[AXIS * in_q + s], L, iL);
        if (dest_cell(p, iL, fn) != my_c) continue;
        const int rank = n_valid++;
        if (rank >= depth) {
          ++n_over;
          continue;
        }
        for (int q = 0; q < Q; ++q)
          put(rank, q, q == AXIS ? p : __fadd_rn(0.0f, in[q * in_q + s]));
      }
    }
    if (AXIS == 2) {
      for (int s = 0; s < S; ++s) {
        if (!(strag[(Q - 1) * S + s] > 0.5f)) continue;
        float p[3];
        bool mine = true;
        for (int d = 0; d < 3; ++d) {
          p[d] = wrap_pos(strag[d * S + s], g.L[d], g.iL[d]);
          mine = mine && dest_cell(p[d], g.iL[d], static_cast<float>(nc[d])) ==
                             static_cast<float>(my[d]);
        }
        if (!mine) continue;
        const int rank = n_valid++;
        if (rank >= depth) {
          ++n_over;
          continue;
        }
        for (int q = 0; q < Q; ++q) put(rank, q, q < 3 ? p[q] : __fadd_rn(0.0f, strag[q * S + s]));
      }
    }
    for (int r = min(n_valid, depth); r < depth; ++r)
      for (int q = 0; q < Q; ++q) put(r, q, q < 3 ? kEmptyPos : 0.0f);
  }
  // every lane of the warp reaches here (no early return)
  n_valid = __reduce_add_sync(0xffffffffu, n_valid);
  n_over = __reduce_add_sync(0xffffffffu, n_over);
  if ((threadIdx.x & 31) == 0) {
    if (AXIS == 0) atomicAdd(&counts[0], n_valid);
    atomicAdd(&counts[1], n_over);
  }
}

}  // namespace

// in: [Q, nz, nyb, cap, nlane]; strag: [Q, S]; wz, wy: scratch
// [Q, nz, nyb, cap + ocap, nlane]; out: like in; mini: [Q, nz, nyb, ocap,
// nlane]; counts: int32[2], zeroed by the caller -> (count, overflow).
extern "C" int uammd_sep_rebin(void* in, void* strag, void* wz, void* wy, void* out,
                               void* mini, void* counts, int Q, int S, int nx, int nyb,
                               int nz, int F, int cap, int ocap, float Lx, float Ly,
                               float Lz, float iLx, float iLy, float iLz, void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, {Lx, Ly, Lz}, {iLx, iLy, iLz}};
  const int wide = cap + ocap;
  const int ncell = nz * nyb * g.nlane;
  const int threads = 128;
  const int blocks = (ncell + threads - 1) / threads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* cnt = static_cast<int*>(counts);
  const float* sp = static_cast<const float*>(strag);
  sep_pass<2><<<blocks, threads, 0, st>>>(static_cast<const float*>(in), cap, sp, S,
                                          static_cast<float*>(wz), nullptr, wide, wide, cnt,
                                          Q, g);
  sep_pass<1><<<blocks, threads, 0, st>>>(static_cast<const float*>(wz), wide, sp, 0,
                                          static_cast<float*>(wy), nullptr, wide, wide, cnt,
                                          Q, g);
  sep_pass<0><<<blocks, threads, 0, st>>>(static_cast<const float*>(wy), wide, sp, 0,
                                          static_cast<float*>(out), static_cast<float*>(mini),
                                          cap, wide, cnt, Q, g);
  return static_cast<int>(cudaGetLastError());
}

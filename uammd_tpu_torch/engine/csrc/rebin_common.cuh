// Device code shared by the slot rebins #3 (rebin.cu), #4 (rebin2.cu) and
// #5 (sep_rebin.cu), for Hopper (sm_90a).
//
// The rule of every rebin here (rebin_kernel._wrapped_cell, the sort
// rebin's): a particle belongs to the cell of its wrapped coordinate
// p - L rint(p (1/L)) and is stored at that wrapped value. p/L is p * (1/L)
// with the float32 reciprocal (XLA's rewrite of the TPU kernels' division
// by a constant), and every float operation that decides a cell or a
// wrapped coordinate is an explicit round-to-nearest intrinsic (no FMA
// contraction), so the kernels equal their plain versions bit for bit.
//
// rebin_classify computes each particle's destination once: one code byte
// a slot, 16 (oz + 1) + 4 (oy + 1) + (ox + 1) for the offset o of the
// wrapped coordinate's cell from the slot's own cell (-1, 0 or +1 on each
// axis, periodic), with 3 in an axis's field when the cell there is
// farther or not a number, and 0xff for an empty slot. A destination
// matches a source's particles by one byte compare (want_code); a pass
// that fixes only some axes (#5's intermediate counts) masks the other
// fields first. The codes are stored column by column, [nz, nyb, NLANE,
// CPAD] with CPAD = CAP rounded up to 16, so that a column's codes are one
// to three 16-byte words. #4 and #5 also launch one more row of blocks,
// which classifies the straggler rows [Q, S] by their full cell: the flat
// index (z nyb + yb) NLANE + lane of the cell that claims a row, or -1; a
// pull block lists the rows of its row of cells with row_stragglers.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace rebin {
namespace {  // internal linkage: each library that includes this has its own copy

constexpr float kEmptyPos = 1.0e9f;
constexpr unsigned kEmptyCode = 0xffu;
constexpr unsigned kFar = 3u;  // a field: farther than one cell, or not a number
constexpr int kLaneBits = 10;  // a straggler list entry: row << kLaneBits | lane

struct Geom {
  int nx, nyb, nz, F, cap, nlane;
  int cpad;     // CAP rounded up to 16: the bytes of a code column
  float L[3];   // box lengths x, y, z
  float iL[3];  // their float32 reciprocals
};

__host__ __device__ inline int cpad_of(int cap) { return (cap + 15) / 16 * 16; }

// floor((p/L + 0.5 - floor(p/L + 0.5)) * n), as the TPU kernels compute it.
__device__ __forceinline__ float dest_cell(float p, float iL, float n) {
  const float fr = __fadd_rn(__fmul_rn(p, iL), 0.5f);
  return floorf(__fmul_rn(__fsub_rn(fr, floorf(fr)), n));
}

// 0 + (p - L*round(p/L)) with round-half-to-even (jnp.round).
__device__ __forceinline__ float wrap_pos(float p, float L, float iL) {
  return __fadd_rn(0.0f, __fsub_rn(p, __fmul_rn(L, rintf(__fmul_rn(p, iL)))));
}

// The field of cell c seen from cell s on an axis of n >= 3 cells: 1 + the
// periodic offset (-1, 0 or 1), or kFar when c is farther or not a number.
__device__ __forceinline__ unsigned field_of(float c, int s, int n) {
  const float d = c - static_cast<float>(s);  // small integers: exact
  if (d == 0.0f) return 1u;
  if (d == 1.0f || d == static_cast<float>(1 - n)) return 2u;
  if (d == -1.0f || d == static_cast<float>(n - 1)) return 0u;
  return kFar;
}

// The code of the particles of the source cell at offset (dx, dy, dz) from
// a destination that belong to that destination.
__host__ __device__ constexpr unsigned want_code(int dx, int dy, int dz) {
  return 16u * (1 - dz) + 4u * (1 - dy) + (1 - dx);
}

// The flat index of the cell that claims straggler row s by its full cell,
// or -1 (empty, or a coordinate whose cell is not a cell of the grid).
__device__ int strag_cell(const float* __restrict__ strag, int S, int s, int Q,
                          const Geom& g) {
  if (!(strag[(Q - 1) * S + s] > 0.5f)) return -1;  // pid travels as pid+1
  const int n[3] = {g.nx, g.nyb * g.F, g.nz};
  int c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float fn = static_cast<float>(n[d]);
    const float cf = dest_cell(wrap_pos(strag[d * S + s], g.L[d], g.iL[d]), g.iL[d], fn);
    if (!(cf >= 0.0f && cf < fn)) return -1;
    c[d] = static_cast<int>(cf);
  }
  const int yb = c[1] / g.F;
  return (c[2] * g.nyb + yb) * g.nlane + c[0] * g.F + (c[1] - yb * g.F);
}

// Blocks (nyb, nz) of NLANE x CPAD/16 threads: one thread a source column and
// 16 rows. It reads the 16 slots' pid, x, y, z (64 independent loads,
// coalesced across the lanes) and writes their 16 code bytes as one 16-byte
// store. A grid of nz + 1 rows of blocks classifies the S straggler rows
// ``strag`` into ``scell`` in its last row. ``counts`` (may be null): two
// ints zeroed here for the pull that follows on the stream.
__global__ void __launch_bounds__(1024) rebin_classify(const float* __restrict__ in,
                                                       unsigned char* __restrict__ codes,
                                                       const float* __restrict__ strag, int S,
                                                       int* __restrict__ scell,
                                                       int* __restrict__ counts, int Q, Geom g) {
  if (counts != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x < 2 &&
      threadIdx.y == 0)
    counts[threadIdx.x] = 0;
  if (static_cast<int>(blockIdx.y) == g.nz) {
    const int per = blockDim.x * blockDim.y;
    for (int s = blockIdx.x * per + threadIdx.y * blockDim.x + threadIdx.x; s < S;
         s += gridDim.x * per)
      scell[s] = strag_cell(strag, S, s, Q, g);
    return;
  }
  const int lane = threadIdx.x;
  const int grp = threadIdx.y;  // rows 16 grp .. 16 grp + 15
  const int yb = blockIdx.x;
  const int zc = blockIdx.y;
  const int cx = lane / g.F;
  const int cy = yb * g.F + (lane - cx * g.F);
  const int ny = g.nyb * g.F;
  const float fnx = static_cast<float>(g.nx);
  const float fny = static_cast<float>(ny);
  const float fnz = static_cast<float>(g.nz);
  const size_t plane = static_cast<size_t>(g.cap) * g.nlane;
  const size_t qstride = static_cast<size_t>(g.nz) * g.nyb * plane;
  const size_t zyb = static_cast<size_t>(zc) * g.nyb + yb;
  const float* col = in + zyb * plane + lane;
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = grp * 16 + i * 4 + b;
      unsigned code = kEmptyCode;
      if (r < g.cap) {
        const float* s = col + static_cast<size_t>(r) * g.nlane;
        const float pid = s[(Q - 1) * qstride];  // pid travels as pid+1
        const float px = s[0];
        const float py = s[qstride];
        const float pz = s[2 * qstride];
        if (pid > 0.5f) {
          const unsigned ox =
              field_of(dest_cell(wrap_pos(px, g.L[0], g.iL[0]), g.iL[0], fnx), cx, g.nx);
          const unsigned oy =
              field_of(dest_cell(wrap_pos(py, g.L[1], g.iL[1]), g.iL[1], fny), cy, ny);
          const unsigned oz =
              field_of(dest_cell(wrap_pos(pz, g.L[2], g.iL[2]), g.iL[2], fnz), zc, g.nz);
          code = 16u * oz + 4u * oy + ox;
        }
      }
      word |= code << (8 * b);
    }
    w[i] = word;
  }
  reinterpret_cast<uint4*>(codes + (zyb * g.nlane + lane) * g.cpad)[grp] =
      make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int wrap_index(int s, int n) {
  return s < 0 ? s + n : (s >= n ? s - n : s);
}

// The source column at offset (dx, dy, dz) of the destination cell (cx, cy,
// zc): its slot 0 in the planes and its codes.
struct Source {
  int slot0;
  const unsigned char* codes;
};

__device__ __forceinline__ Source source_at(int dx, int dy, int dz, int cx, int cy, int zc,
                                            const unsigned char* codes, const Geom& g) {
  const int ny = g.nyb * g.F;
  const int sz = wrap_index(zc + dz, g.nz);
  const int sy = wrap_index(cy + dy, ny);
  const int sx = wrap_index(cx + dx, g.nx);
  const int syb = sy / g.F;
  const int sl = sx * g.F + (sy - syb * g.F);
  const int szyb = sz * g.nyb + syb;
  return Source{szyb * g.cap * g.nlane + sl,
                codes + (static_cast<size_t>(szyb) * g.nlane + sl) * g.cpad};
}

// The straggler rows whose cell (scell, from rebin_classify's last row of
// blocks) lies in a pull block's row of cells [cell0, cell0 + nlane), in
// row order: row << kLaneBits | lane into slist [S]; returns their number.
// wcount: 32 ints of shared memory. Every thread of the block calls it.
__device__ int row_stragglers(const int* __restrict__ scell, int S, int cell0, int nlane,
                              int* wcount, int* slist) {
  const int tid = threadIdx.x;
  const int nwarps = blockDim.x >> 5;
  int nrow = 0;
  for (int base = 0; base < S; base += blockDim.x) {
    const int s = base + tid;
    const int l = s < S ? scell[s] - cell0 : -1;
    const bool mine = l >= 0 && l < nlane;
    const unsigned b = __ballot_sync(0xffffffffu, mine);
    if ((tid & 31) == 0) wcount[tid >> 5] = __popc(b);
    __syncthreads();
    int off = nrow;
    for (int w = 0; w < nwarps; ++w) {
      if (w < (tid >> 5)) off += wcount[w];
      nrow += wcount[w];
    }
    if (mine) slist[off + __popc(b & ((1u << (tid & 31)) - 1u))] = (s << kLaneBits) | l;
    __syncthreads();
  }
  return nrow;
}

// The rows of slist [nrow] whose lane is c.
__device__ __forceinline__ int lane_rows(const int* slist, int nrow, int c) {
  int k = 0;
  for (int i = 0; i < nrow; ++i) k += (slist[i] & ((1 << kLaneBits) - 1)) == c;
  return k;
}

// 0x01 in each byte of w equal to the byte of want4 (want4 = code x 0x01010101)
__device__ __forceinline__ unsigned byte_hits(unsigned w, unsigned want4) {
  return __vcmpeq4(w, want4) & 0x01010101u;
}

}  // namespace
}  // namespace rebin

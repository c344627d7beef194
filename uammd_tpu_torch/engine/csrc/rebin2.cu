// One-shot straggler-aware rebin of the grid-resident layout, for Hopper
// (sm_90a): one classify-and-pull launch pair.
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
// Contract (rebin_kernel.rebin2_plain; JAX's rank order and overflow rule):
// each cell ranks its candidates from the 27 source cells in the order dz,
// dy, dx (each -1, 0, 1; #3's order), source slots ascending, then the
// straggler rows in order. Ranks below CAP go to `out`, ranks CAP ..
// CAP+OCAP-1 to the overflow mini-grid `mini` [Q, nz, nyb, OCAP, NLANE] (the
// next straggler set, compacted outside), and ranks past CAP+OCAP are
// counted as overflow. A candidate belongs to the cell of its wrapped
// coordinate p - L rint(p (1/L)) and is stored at that value (the sort
// rebin's rule, rebin_common.cuh; no image shift); the rest
// pass as 0 + v (-0 becomes +0), unfilled slots get EMPTY_POS on x, y, z
// and 0 elsewhere. So the output equals its plain version slot for slot and
// bit for bit. counts[0] gets every claimed candidate (the caller also
// flags count != n: a particle moved more than one cell) and counts[1] the
// ranks past CAP + OCAP.
//
// What bounded the thread-per-cell design this replaces (0.523 ms on an
// H100 at the unfused v2 path's [42, 10, 32, 128], 16x its byte bound):
// each destination thread walked all 27 x CAP source slots one at a time,
// recomputing each one's wrapped cell (every slot classified 27 times, one
// dependent load chain in flight a thread), then all S straggler rows, and
// wrote its ranks one at a time, 4 bytes to a sector.
//
// Design, #5's (sep_rebin.cu) in #3's order:
// 1. classify (rebin_common.cuh): a code byte a slot, the offset of its
//    destination from its own cell, and in one more row of blocks the full
//    cell of each straggler row (an int a row, -1 for none); it zeroes the
//    counts.
// 2. pull: one block per (z, yb) row of destination cells, four threads a
//    cell. The block first lists its row's straggler rows in row order
//    (row_stragglers). Each thread takes 7 of the 27 sources in (dz, dy,
//    dx) order, the last thread also the cell's straggler rows, matches the
//    code columns (16-byte loads) four bytes at a time (__vcmpeq4, popc);
//    the quarters' exclusive prefix (shuffles) gives each its first rank, a
//    second pass over the same codes writes each match's source slot (a
//    straggler as -1 - row) at its rank into a shared table [CAP +
//    OCAP][NLANE], and the block writes the out and mini rows in memory
//    order, gathering each rank's Q values (or the fill).
// Launch plan (rebin_kernel.rebin2_launch_plan): classify (nyb, nz + 1)
// blocks of NLANE x CPAD/16 threads; pull (nyb, nz) blocks of 4 NLANE
// threads rounded up to a warp, 4 ((CAP + OCAP + 1) NLANE + 32 + S) bytes
// of shared memory. One scratch holds the codes, the straggler cells and
// the counts.
//
// What bounds it: memory. The function reads Q input planes and the
// straggler rows and writes Q output planes and the mini-grid; classify
// reads 4 of the planes a second time and both kernels move one code byte a
// slot.

#include <cuda_runtime.h>

#include <cstddef>

#include "rebin_common.cuh"

namespace {

using rebin::Geom;
using rebin::kEmptyPos;

constexpr int kParts = 4;  // threads of a destination cell in the pull
constexpr int kSourcesPerPart = 7;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the opt-in limit of sm_90

__host__ __device__ inline int pull_threads(int nlane) {
  return (kParts * nlane + 31) / 32 * 32;
}

size_t pull_smem(int wide, int nlane, int S) {
  return sizeof(int) * ((static_cast<size_t>(wide) + 1) * nlane + 32 + S);
}

// The source column of rank-order index k (0..26: dz, then dy, then dx, each
// -1, 0, 1) of the destination cell (cx, cy, zc), and the code of its
// particles that belong to the destination.
__device__ __forceinline__ rebin::Source source_of(int k, int cx, int cy, int zc,
                                                   const unsigned char* codes, const Geom& g,
                                                   unsigned* want4) {
  const int dz = k / 9 - 1;
  const int dy = (k / 3) % 3 - 1;
  const int dx = k % 3 - 1;
  *want4 = rebin::want_code(dx, dy, dz) * 0x01010101u;
  return rebin::source_at(dx, dy, dz, cx, cy, zc, codes, g);
}

// Q: the quantities carried, 7 (the v2 engine's rebin) or 4
template <int Q>
__global__ void __launch_bounds__(512)
    rebin2_pull(const float* __restrict__ in, const unsigned char* __restrict__ codes,
                const float* __restrict__ strag, const int* __restrict__ scell, int S,
                float* __restrict__ out, float* __restrict__ mini, int* __restrict__ counts,
                int ocap, Geom g) {
  extern __shared__ int smem[];
  const int wide = g.cap + ocap;
  int* sidx = smem;                    // [wide][nlane]: the source of each rank
  int* nfill = sidx + wide * g.nlane;  // [nlane]: the filled ranks of each cell
  int* wcount = nfill + g.nlane;       // [32]: a warp's stragglers in a round
  int* slist = wcount + 32;            // [S]: this row's stragglers, in row order
  const int tid = threadIdx.x;
  const int yb = blockIdx.x;
  const int zc = blockIdx.y;
  const int zyb = zc * g.nyb + yb;

  // 0. the straggler rows whose cell lies in this row of cells, in order
  const int nrow = rebin::row_stragglers(scell, S, zyb * g.nlane, g.nlane, wcount, slist);

  // 1. this quarter's matches (the last quarter's with the cell's
  // straggler rows, which rank after the 27 sources), then the prefix
  const int c = tid / kParts;  // destination lane
  const int part = tid - c * kParts;
  const bool cell_ok = c < g.nlane;
  const int cx = c / g.F;
  const int cy = yb * g.F + (c - cx * g.F);
  const int k0 = part * kSourcesPerPart;
  const int k1 = min(27, k0 + kSourcesPerPart);
  const bool last = k1 == 27;
  const int vecs = g.cpad / 16;
  int n = 0;
  if (cell_ok) {
    for (int k = k0; k < k1; ++k) {
      unsigned want4;
      const rebin::Source src = source_of(k, cx, cy, zc, codes, g, &want4);
      const uint4* p = reinterpret_cast<const uint4*>(src.codes);
      for (int i = 0; i < vecs; ++i) {
        const uint4 v = p[i];
        n += __popc(rebin::byte_hits(v.x, want4)) + __popc(rebin::byte_hits(v.y, want4)) +
             __popc(rebin::byte_hits(v.z, want4)) + __popc(rebin::byte_hits(v.w, want4));
      }
    }
    if (last) n += rebin::lane_rows(slist, nrow, c);
  }
  // the 4 threads of a cell are consecutive lanes
  int incl = n;
#pragma unroll
  for (int d = 1; d < kParts; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d, kParts);
    if (part >= d) incl += t;
  }
  const int total = __shfl_sync(0xffffffffu, incl, kParts - 1, kParts);
  int rank = incl - n;

  // 2. each match's source at its rank (ranks past wide are dropped)
  if (cell_ok && n > 0 && rank < wide) {
    for (int k = k0; k < k1 && rank < wide; ++k) {
      unsigned want4;
      const rebin::Source src = source_of(k, cx, cy, zc, codes, g, &want4);
      const unsigned* p = reinterpret_cast<const unsigned*>(src.codes);
      for (int i = 0; i < g.cpad / 4 && rank < wide; ++i) {
        unsigned hit = rebin::byte_hits(p[i], want4);
        while (hit && rank < wide) {
          const int row = 4 * i + (__ffs(hit) - 1) / 8;
          hit &= hit - 1;
          sidx[rank * g.nlane + c] = src.slot0 + row * g.nlane;
          ++rank;
        }
      }
    }
    if (last) {
      for (int i = 0; i < nrow && rank < wide; ++i) {
        if ((slist[i] & ((1 << rebin::kLaneBits) - 1)) == c) {
          sidx[rank * g.nlane + c] = -1 - (slist[i] >> rebin::kLaneBits);
          ++rank;
        }
      }
    }
  }
  if (cell_ok && part == 0) nfill[c] = min(total, wide);
  __syncthreads();

  // 3. the out rows (ranks < cap), then the mini rows, in memory order
  const int plane = g.cap * g.nlane;
  const int qstride = g.nz * g.nyb * plane;
  const int mstride = g.nz * g.nyb * ocap * g.nlane;
  float* o0 = out + zyb * plane;
  float* m0 = mini + zyb * ocap * g.nlane;
  for (int e = tid; e < wide * g.nlane; e += blockDim.x) {
    const int r = e / g.nlane;
    const int l = e - r * g.nlane;
    float* o = e < plane ? o0 + e : m0 + (e - plane);
    const int os = e < plane ? qstride : mstride;
    float v[Q];  // all Q loads in flight before the first store
    if (r < nfill[l]) {
      const int src = sidx[e];
      if (src >= 0) {
#pragma unroll
        for (int q = 0; q < Q; ++q) v[q] = in[src + q * qstride];
      } else {
#pragma unroll
        for (int q = 0; q < Q; ++q) v[q] = strag[q * S + (-1 - src)];
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) v[a] = rebin::wrap_pos(v[a], g.L[a], g.iL[a]);
#pragma unroll
      for (int q = 3; q < Q; ++q) v[q] = __fadd_rn(0.0f, v[q]);
    } else {
#pragma unroll
      for (int q = 0; q < Q; ++q) v[q] = q < 3 ? kEmptyPos : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) o[q * os] = v[q];
  }

  // 4. the counts: one cell's from its first thread
  const bool first = cell_ok && part == 0;
  int n_valid = first ? total : 0;
  int n_over = first ? max(total - wide, 0) : 0;
  n_valid = __reduce_add_sync(0xffffffffu, n_valid);
  n_over = __reduce_add_sync(0xffffffffu, n_over);
  if ((tid & 31) == 0) {
    atomicAdd(&counts[0], n_valid);
    atomicAdd(&counts[1], n_over);
  }
}

}  // namespace

// in: [Q, nz, nyb, cap, nlane], Q = 7 or 4; strag: [Q, S]; scratch
// (uammd_rebin2_scratch bytes): uint8 [nz, nyb, nlane, cpad_of(cap)]
// codes, then int32 [S] straggler cells, then the int32 [2] counts (count,
// overflow; zeroed by the classify kernel); out: like in; mini: [Q, nz,
// nyb, ocap, nlane].
extern "C" int uammd_rebin2(void* in, void* strag, void* scratch, void* out, void* mini,
                            int Q, int S, int nx, int nyb, int nz, int F, int cap, int ocap,
                            float Lx, float Ly, float Lz, float iLx, float iLy, float iLz,
                            void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, rebin::cpad_of(cap), {Lx, Ly, Lz}, {iLx, iLy, iLz}};
  const int wide = cap + ocap;
  const size_t slots = static_cast<size_t>(nz) * nyb * wide * g.nlane;
  const size_t smem = pull_smem(wide, g.nlane, S);
  if ((Q != 7 && Q != 4) || nx < 3 || nz < 3 || nyb * F < 3 || cap < 1 || ocap < 0 ||
      S < 1 || S >= (1 << (31 - rebin::kLaneBits)) || g.nlane >= (1 << rebin::kLaneBits) ||
      g.nlane * (g.cpad / 16) > 1024 || pull_threads(g.nlane) > 512 || smem > kMaxSmem ||
      static_cast<size_t>(Q) * slots >= (static_cast<size_t>(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto pull = Q == 7 ? rebin2_pull<7> : rebin2_pull<4>;
  static size_t enabled[2] = {48 * 1024, 48 * 1024};  // dynamic shared memory allowed so far
  if (smem > enabled[Q == 4]) {
    const cudaError_t e = cudaFuncSetAttribute(
        pull, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    enabled[Q == 4] = smem;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* codes = static_cast<unsigned char*>(scratch);
  int* scell = reinterpret_cast<int*>(codes + static_cast<size_t>(nz) * nyb * g.nlane * g.cpad);
  int* counts = scell + S;
  rebin::rebin_classify<<<dim3(nyb, nz + 1), dim3(g.nlane, g.cpad / 16), 0, st>>>(
      static_cast<const float*>(in), codes, static_cast<const float*>(strag), S, scell, counts,
      Q, g);
  pull<<<dim3(nyb, nz), pull_threads(g.nlane), smem, st>>>(
      static_cast<const float*>(in), codes, static_cast<const float*>(strag), scell, S,
      static_cast<float*>(out), static_cast<float*>(mini), counts, ocap, g);
  return static_cast<int>(cudaGetLastError());
}

// The scratch bytes, and the pull kernel's dynamic shared memory and
// threads, for the wrapper's plan to check.
extern "C" long long uammd_rebin2_scratch(int nx, int nyb, int nz, int F, int cap, int S) {
  return static_cast<long long>(nz) * nyb * nx * F * rebin::cpad_of(cap) + 4LL * (S + 2);
}

extern "C" long long uammd_rebin2_smem(int cap, int ocap, int nlane, int S) {
  return static_cast<long long>(pull_smem(cap + ocap, nlane, S));
}

extern "C" int uammd_rebin2_threads(int nlane) { return pull_threads(nlane); }

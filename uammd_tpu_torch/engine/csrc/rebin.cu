// One-shot pull rebin of the grid-resident layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/rebin_kernel.py:make_rebin_kernel
// (pallas_call at :223; kernel body :68-190). Quantities travel stacked as
// [Q, nz, nyb, CAP, NLANE] float32 with x, y, z first and pid+1 last (0 on
// empty slots). Particles move at most one cell between rebins (the drift
// trigger guarantees it), so each destination cell pulls its particles from
// its 27-cell neighborhood.
//
// Contract (rebin_kernel.rebin_plain): a particle belongs to the cell of its
// wrapped coordinate p - L rint(p (1/L)) (the sort rebin's rule; no image
// shift, so a particle within ulps of +-L/2 is kept, where the TPU kernel,
// which tests p +- L before it wraps, can lose it) and is stored at that
// wrapped coordinate. Each destination cell ranks its candidates in the
// order of the 27 source cells (dz, then dy, then dx, each in -1, 0, 1) and
// each source's slots ascending, so the output equals the plain version
// slot for slot and bit for bit. p/L is p * (1/L) with the float32
// reciprocal (XLA's rewrite of the TPU kernel's division by a constant),
// and every float operation that decides a cell or a wrapped position is an
// explicit round-to-nearest intrinsic (no FMA contraction). Unfilled slots
// get EMPTY_POS on x/y/z and 0 elsewhere; values pass as 0 + v, as the TPU
// kernel's one-hot sums do (-0 becomes +0). counts[0] gets the claimed
// candidates and counts[1] those ranked past CAP (integer atomics after a
// warp sum). A NaN or infinite coordinate belongs to no cell.
//
// What bounded the thread-per-cell design this replaces: each destination
// thread walked all 27 x CAP source slots in turn (432 at DPD's CAP 16,
// 1080 at v1's CAP 40), reading a pid and then three positions and running
// three cell tests for each, so every particle's destination was computed
// 27 times, one dependent load chain was in flight a thread, and every
// source plane passed through L1/L2 27 times; the output rows were written
// one rank at a time, 4 bytes to a sector.
//
// Design, two kernels:
// 1. classify (rebin_common.cuh, shared with #5): one thread per (source
//    column, 16 rows). It reads the 16 slots' pid, x, y, z (64 independent
//    loads, coalesced across the lanes), computes each particle's
//    destination once, and writes one code byte a slot: the offset of the
//    destination from the source cell, 2 bits an axis (3 when farther or
//    not finite), 0xff for an empty slot, column by column ([nz, nyb,
//    NLANE, CPAD], CPAD = CAP rounded up to 16), so that a column's codes
//    are one to three 16-byte words.
// 2. pull: one block per (z, yb) row of destination cells, four threads a
//    cell. Each thread takes a quarter of the 27 sources in order, loads
//    their code columns (16-byte loads, independent of each other),
//    matches the wanted code four bytes at a time (__vcmpeq4) and counts
//    with popc; the four counts' exclusive prefix (two shuffles) gives each
//    quarter its first rank, and a second pass over the same codes (L1)
//    writes each match's source slot at its rank into a shared-memory table
//    [CAP][NLANE]. Then the whole block writes the output row by row: for
//    (rank, lane) in memory order it gathers the source slot's Q values (or
//    the fill), so each warp's stores are 128 contiguous bytes.
// Launch plan (rebin_kernel.rebin_launch_plan): classify (nyb, nz) blocks of
// NLANE x CPAD/16 threads, no shared memory; pull (nyb, nz) blocks of
// 4 NLANE threads rounded up to a warp, 4 (CAP + 1) NLANE bytes of shared
// memory (20.5 KB at v1's CAP 40, NLANE 128; 8.7 KB at DPD's CAP 16).
// Registers and spills: ptxas -v, printed by chip_smoke.py.
//
// What bounds it: memory. The function reads and writes each of the Q
// planes once (2 x Q x 4 bytes a slot); classify reads 4 of the planes a
// second time and both kernels move one code byte a slot, about 1.3x the
// bound's bytes at Q = 7.

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

size_t pull_smem(int cap, int nlane) {
  return sizeof(int) * (static_cast<size_t>(cap) + 1) * nlane;
}

// The source column of offset k (0..26 in (dz, dy, dx) order) of the
// destination cell (cx, cy, zc), and the code of its particles that belong
// to the destination.
__device__ __forceinline__ rebin::Source source_of(int k, int cx, int cy, int zc,
                                                   const unsigned char* codes, const Geom& g,
                                                   unsigned* want4) {
  const int dz = k / 9 - 1;
  const int dy = (k / 3) % 3 - 1;
  const int dx = k % 3 - 1;
  *want4 = rebin::want_code(dx, dy, dz) * 0x01010101u;
  return rebin::source_at(dx, dy, dz, cx, cy, zc, codes, g);
}

// Q: the quantities carried, 7 or 10 (the engines' two rebins)
template <int Q>
__global__ void __launch_bounds__(512) rebin_pull(const float* __restrict__ in,
                                                  const unsigned char* __restrict__ codes,
                                                  float* __restrict__ out,
                                                  int* __restrict__ counts, Geom g) {
  extern __shared__ int smem[];
  int* sidx = smem;                     // [cap][nlane]: the source slot of each rank
  int* nfill = smem + g.cap * g.nlane;  // [nlane]: the filled ranks of each cell
  const int tid = threadIdx.x;
  const int yb = blockIdx.x;
  const int zc = blockIdx.y;
  const int c = tid / kParts;  // destination lane
  const int part = tid - c * kParts;
  const bool cell_ok = c < g.nlane;
  const int plane = g.cap * g.nlane;
  const size_t qstride = static_cast<size_t>(g.nz) * g.nyb * plane;
  const int words = g.cpad / 4;

  // 1. this quarter's matches: count, then the quarters' prefix
  const int k0 = part * kSourcesPerPart;
  const int k1 = min(27, k0 + kSourcesPerPart);
  const int cx = c / g.F;
  const int cy = yb * g.F + (c - cx * g.F);
  int n = 0;
  if (cell_ok) {
    for (int k = k0; k < k1; ++k) {
      unsigned want4;
      const rebin::Source src = source_of(k, cx, cy, zc, codes, g, &want4);
      const uint4* p = reinterpret_cast<const uint4*>(src.codes);
      for (int i = 0; i < words / 4; ++i) {
        const uint4 v = p[i];
        n += __popc(rebin::byte_hits(v.x, want4)) + __popc(rebin::byte_hits(v.y, want4)) +
             __popc(rebin::byte_hits(v.z, want4)) + __popc(rebin::byte_hits(v.w, want4));
      }
    }
  }
  // inclusive prefix over the 4 threads of the cell (consecutive lanes)
  int incl = n;
#pragma unroll
  for (int d = 1; d < kParts; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d, kParts);
    if (part >= d) incl += t;
  }
  const int total = __shfl_sync(0xffffffffu, incl, kParts - 1, kParts);
  int rank = incl - n;

  // 2. each match's source slot at its rank (ranks past CAP are dropped)
  if (cell_ok && n > 0 && rank < g.cap) {
    for (int k = k0; k < k1 && rank < g.cap; ++k) {
      unsigned want4;
      const rebin::Source src = source_of(k, cx, cy, zc, codes, g, &want4);
      const unsigned* p = reinterpret_cast<const unsigned*>(src.codes);
      for (int i = 0; i < words && rank < g.cap; ++i) {
        unsigned hit = rebin::byte_hits(p[i], want4);
        while (hit && rank < g.cap) {
          const int row = 4 * i + (__ffs(hit) - 1) / 8;
          hit &= hit - 1;
          sidx[rank * g.nlane + c] = src.slot0 + row * g.nlane;
          ++rank;
        }
      }
    }
  }
  if (cell_ok && part == 0) nfill[c] = min(total, g.cap);
  __syncthreads();

  // 3. the output rows of the block, in memory order: (rank, lane)
  const size_t dst0 = (static_cast<size_t>(zc) * g.nyb + yb) * plane;
  for (int e = tid; e < plane; e += blockDim.x) {
    const int r = e / g.nlane;
    const int l = e - r * g.nlane;
    float* o = out + dst0 + e;
    if (r < nfill[l]) {
      const float* s = in + sidx[e];
      float v[Q];  // all Q loads in flight before the first store
#pragma unroll
      for (int q = 0; q < Q; ++q) v[q] = s[q * qstride];
      o[0] = rebin::wrap_pos(v[0], g.L[0], g.iL[0]);
      o[qstride] = rebin::wrap_pos(v[1], g.L[1], g.iL[1]);
      o[2 * qstride] = rebin::wrap_pos(v[2], g.L[2], g.iL[2]);
#pragma unroll
      for (int q = 3; q < Q; ++q) o[q * qstride] = __fadd_rn(0.0f, v[q]);
    } else {
      o[0] = kEmptyPos;
      o[qstride] = kEmptyPos;
      o[2 * qstride] = kEmptyPos;
#pragma unroll
      for (int q = 3; q < Q; ++q) o[q * qstride] = 0.0f;
    }
  }

  // 4. the counts: one cell's total from its first thread
  int n_valid = cell_ok && part == 0 ? total : 0;
  int n_over = cell_ok && part == 0 ? max(total - g.cap, 0) : 0;
  n_valid = __reduce_add_sync(0xffffffffu, n_valid);
  n_over = __reduce_add_sync(0xffffffffu, n_over);
  if ((tid & 31) == 0) {
    atomicAdd(&counts[0], n_valid);
    atomicAdd(&counts[1], n_over);
  }
}

}  // namespace

// in: [Q, nz, nyb, cap, nlane], Q = 7 or 10; codes: uint8 scratch [nz, nyb, nlane,
// cpad_of(cap)]; out: like in; counts: int32[2], zeroed by the caller ->
// (claimed candidates, ranked past cap).
extern "C" int uammd_rebin(void* in, void* codes, void* out, void* counts, int Q, int nx,
                           int nyb, int nz, int F, int cap, float Lx, float Ly, float Lz,
                           float iLx, float iLy, float iLz, void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, rebin::cpad_of(cap), {Lx, Ly, Lz}, {iLx, iLy, iLz}};
  const size_t slots = static_cast<size_t>(nz) * nyb * cap * g.nlane;
  const size_t smem = pull_smem(cap, g.nlane);
  if ((Q != 7 && Q != 10) || nx < 3 || nz < 3 || nyb * F < 3 || cap < 1 ||
      g.nlane * (g.cpad / 16) > 1024 || pull_threads(g.nlane) > 512 || smem > kMaxSmem ||
      slots >= (static_cast<size_t>(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto pull = Q == 7 ? rebin_pull<7> : rebin_pull<10>;
  static size_t enabled[2] = {48 * 1024, 48 * 1024};  // dynamic shared memory allowed so far
  if (smem > enabled[Q == 10]) {
    const cudaError_t e = cudaFuncSetAttribute(
        pull, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    enabled[Q == 10] = smem;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nyb, nz);
  rebin::rebin_classify<<<grid, dim3(g.nlane, g.cpad / 16), 0, st>>>(
      static_cast<const float*>(in), static_cast<unsigned char*>(codes), nullptr, 0, nullptr,
      nullptr, Q, g);
  pull<<<grid, pull_threads(g.nlane), smem, st>>>(
      static_cast<const float*>(in), static_cast<const unsigned char*>(codes),
      static_cast<float*>(out), static_cast<int*>(counts), g);
  return static_cast<int>(cudaGetLastError());
}

// The pull kernel's dynamic shared memory and threads, for the wrapper's
// plan to check.
extern "C" long long uammd_rebin_smem(int cap, int nlane) {
  return static_cast<long long>(pull_smem(cap, nlane));
}

extern "C" int uammd_rebin_threads(int nlane) { return pull_threads(nlane); }

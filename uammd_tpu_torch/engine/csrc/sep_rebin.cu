// Separable rebin with straggler rows, for Hopper (sm_90a): the three
// passes' result in one classify-and-pull launch pair.
//
// Replaces the TPU kernel uammd_tpu/engine/rebin_kernel.py:
// make_separable_rebin (pallas_calls at :904, :920, :934 over _sep_place,
// :626, and the widening at :952). Quantities travel stacked as
// [Q, nz, nyb, CAP, NLANE] float32 with x, y, z first and pid+1 last; the
// straggler rows as [Q, S].
//
// Contract (rebin_kernel.separable_rebin_plain): three passes, z (absorbing
// the straggler rows, each claimed by its full cell), then y, then x, each
// pulling into every cell the particles of its 3 neighbours along the
// pass's axis whose wrapped coordinate falls in it (the sort rebin's rule,
// rebin_common.cuh), at the wide capacity CAP + OCAP; the x pass's ranks
// below CAP go to ``out``, CAP .. CAP+OCAP-1 to the mini-grid [Q, nz, nyb,
// OCAP, NLANE], and a rank past CAP + OCAP in any pass is overflow. Where
// the plain version reports no overflow, out, mini, count and overflow
// equal it bit for bit. Where it does, the caller latches the state as
// invalid (overflow > 0), and only that flag is held equal: this kernel
// drops no intermediate particle, so its count and overflow sum can differ
// from the passes' then.
//
// What bounded the three-pass design this replaces: one thread per
// destination cell and pass walked 3 x (CAP + OCAP) source slots one at a
// time (a pid load, a coordinate load, a cell test each: one load chain in
// flight a thread), computed every particle's destination along an axis
// three times, and wrote and read back two [Q, nz, nyb, CAP + OCAP, NLANE]
// intermediates, each rank written on its own.
//
// Design, two kernels, no intermediate grid:
// 1. classify (rebin_common.cuh, #3's): a code byte a slot, the offset of
//    its destination on each axis (3 in an axis that is farther or not a
//    number), and, in one more row of blocks, the full cell of each
//    straggler row (an int a row, -1 for none).
// 2. pull: one block per (z, yb) row of destination cells, four threads a
//    cell. The passes' order, read through them: a cell's particles come
//    by source (dx, then dy, then dz, each -1, 0, +1), each source's slots
//    ascending, and the straggler rows of the cell (in row order) right
//    after source (0, 0, +1), the end of the z pass into the column the x
//    and y passes keep. Each thread takes 7 of those 27 sources in order,
//    matches their code columns (16-byte loads) four bytes at a time
//    (__vcmpeq4, popc) and also counts, with the other axes' fields masked
//    off, the source's particles that the z pass (dx = dy = 0) and the y
//    pass (dx = 0) bring into the same cell: the intermediate occupancies,
//    whose ranks past CAP + OCAP the passes count as overflow. The
//    quarters' exclusive prefix (shuffles) gives each its first rank, a
//    second pass over the same codes writes each match's source slot (a
//    straggler as -1 - row) at its rank into a shared table [CAP +
//    OCAP][NLANE], and the block writes the out and mini rows in memory
//    order, gathering each rank's Q values (or the fill). A straggler's x
//    and y are stored wrapped twice, as the passes store them (the z pass
//    wraps all three, the y and x passes their axis again); its cell is
//    that of the coordinates wrapped once, equal to the twice-wrapped
//    ones' for |p| <= L (tests/test_torch_sep_rebin_pull.py), where every
//    path's stragglers lie (stored wrapped, moved less than the drift
//    threshold since).
//    ``order`` is 0; the checks' controls set 1 (sources in #3's (dz, dy,
//    dx) order) or 2 (the straggler rows after the last source), which must
//    change the output.
// As rebin.cu: values pass as 0 + v, unfilled rows get EMPTY_POS on x, y, z
// and 0 elsewhere; counts[0] gets the x pass's claimed candidates and
// counts[1] the ranks past CAP + OCAP of the three passes (integer atomics
// after a warp sum; the classify kernel zeroes them, so the wrapper's one
// scratch allocation holds codes, straggler cells and counts). Launch plan
// (rebin_kernel.sep_rebin_launch_plan): classify (nyb, nz + 1) blocks of
// NLANE x CPAD/16 threads; pull (nyb, nz) blocks of 4 NLANE threads rounded
// up to a warp, 4 ((CAP + OCAP + 1) NLANE + 32 + S) bytes of shared memory
// (21 KB at v2, 23 KB at the PSE near grid). Registers and spills: ptxas -v,
// printed and checked by chip_smoke.py (sep_pull<7> 40 registers, <4> 36,
// rebin_classify 32; no spill).
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

// The offset (dx, dy, dz) of the j-th source of a destination in rank order.
__device__ __forceinline__ int3 source_offset(int j, int order) {
  const int a = j / 9 - 1;
  const int b = (j / 3) % 3 - 1;
  const int c = j % 3 - 1;
  return order == 1 ? make_int3(c, b, a) : make_int3(a, b, c);
}

__device__ __forceinline__ int hits4(uint4 v, unsigned mask4, unsigned want4) {
  return __popc(rebin::byte_hits(v.x & mask4, want4)) +
         __popc(rebin::byte_hits(v.y & mask4, want4)) +
         __popc(rebin::byte_hits(v.z & mask4, want4)) +
         __popc(rebin::byte_hits(v.w & mask4, want4));
}

// Q: the quantities carried, 7 (the LJ engines) or 4 (the PSE near grid)
template <int Q>
__global__ void __launch_bounds__(512)
    sep_pull(const float* __restrict__ in, const unsigned char* __restrict__ codes,
             const float* __restrict__ strag, const int* __restrict__ scell, int S,
             float* __restrict__ out, float* __restrict__ mini, int* __restrict__ counts,
             int ocap, int order, Geom g) {
  extern __shared__ int smem[];
  const int wide = g.cap + ocap;
  int* sidx = smem;                      // [wide][nlane]: the source of each rank
  int* nfill = sidx + wide * g.nlane;    // [nlane]: the filled ranks of each cell
  int* wcount = nfill + g.nlane;         // [32]: a warp's stragglers in a round
  int* slist = wcount + 32;              // [S]: this row's stragglers, in row order
  const int tid = threadIdx.x;
  const int yb = blockIdx.x;
  const int zc = blockIdx.y;
  const int zyb = zc * g.nyb + yb;

  // 0. the straggler rows whose cell lies in this row of cells, in order
  const int nrow = rebin::row_stragglers(scell, S, zyb * g.nlane, g.nlane, wcount, slist);

  // 1. this quarter's matches and intermediate counts, then the prefix
  const int c = tid / kParts;  // destination lane
  const int part = tid - c * kParts;
  const bool cell_ok = c < g.nlane;
  const int cx = c / g.F;
  const int cy = yb * g.F + (c - cx * g.F);
  const int j0 = part * kSourcesPerPart;
  const int j1 = min(27, j0 + kSourcesPerPart);
  const int js = order == 0 ? 14 : (order == 1 ? 22 : 26);  // the stragglers follow it
  const int vecs = g.cpad / 16;
  int n = 0, n_y = 0, n_z = 0;
  if (cell_ok) {
    for (int j = j0; j < j1; ++j) {
      const int3 d = source_offset(j, order);
      const rebin::Source src = rebin::source_at(d.x, d.y, d.z, cx, cy, zc, codes, g);
      const unsigned want = rebin::want_code(d.x, d.y, d.z);
      const uint4* p = reinterpret_cast<const uint4*>(src.codes);
      for (int i = 0; i < vecs; ++i) {
        const uint4 v = p[i];
        n += hits4(v, 0xffffffffu, want * 0x01010101u);
        if (d.x == 0) n_y += hits4(v, 0x3c3c3c3cu, (want & 0x3cu) * 0x01010101u);
        if (d.x == 0 && d.y == 0) n_z += hits4(v, 0x30303030u, (want & 0x30u) * 0x01010101u);
      }
      if (j == js) {
        const int ns = rebin::lane_rows(slist, nrow, c);
        n += ns;
        n_y += ns;
        n_z += ns;
      }
    }
  }
  // the 4 threads of a cell are consecutive lanes
  int incl = n;
#pragma unroll
  for (int d = 1; d < kParts; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d, kParts);
    if (part >= d) incl += t;
  }
  const int total = __shfl_sync(0xffffffffu, incl, kParts - 1, kParts);
#pragma unroll
  for (int d = 1; d < kParts; d <<= 1) {
    n_y += __shfl_xor_sync(0xffffffffu, n_y, d, kParts);
    n_z += __shfl_xor_sync(0xffffffffu, n_z, d, kParts);
  }
  int rank = incl - n;

  // 2. each match's source at its rank (ranks past wide are dropped)
  if (cell_ok && n > 0 && rank < wide) {
    for (int j = j0; j < j1 && rank < wide; ++j) {
      const int3 d = source_offset(j, order);
      const rebin::Source src = rebin::source_at(d.x, d.y, d.z, cx, cy, zc, codes, g);
      const unsigned want4 = rebin::want_code(d.x, d.y, d.z) * 0x01010101u;
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
      if (j == js) {
        for (int i = 0; i < nrow && rank < wide; ++i) {
          if ((slist[i] & ((1 << rebin::kLaneBits) - 1)) == c) {
            sidx[rank * g.nlane + c] = -1 - (slist[i] >> rebin::kLaneBits);
            ++rank;
          }
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
#pragma unroll
        for (int a = 0; a < 3; ++a) v[a] = rebin::wrap_pos(v[a], g.L[a], g.iL[a]);
      } else {
        const int s = -1 - src;
#pragma unroll
        for (int q = 0; q < Q; ++q) v[q] = strag[q * S + s];
#pragma unroll
        for (int a = 0; a < 3; ++a) v[a] = rebin::wrap_pos(v[a], g.L[a], g.iL[a]);
        v[0] = rebin::wrap_pos(v[0], g.L[0], g.iL[0]);  // the x and y passes'
        v[1] = rebin::wrap_pos(v[1], g.L[1], g.iL[1]);
      }
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
  int n_over = first ? max(n_z - wide, 0) + max(n_y - wide, 0) + max(total - wide, 0) : 0;
  n_valid = __reduce_add_sync(0xffffffffu, n_valid);
  n_over = __reduce_add_sync(0xffffffffu, n_over);
  if ((tid & 31) == 0) {
    atomicAdd(&counts[0], n_valid);
    atomicAdd(&counts[1], n_over);
  }
}

}  // namespace

// in: [Q, nz, nyb, cap, nlane], Q = 7 or 4; strag: [Q, S]; scratch
// (uammd_sep_rebin_scratch bytes): uint8 [nz, nyb, nlane, cpad_of(cap)]
// codes, then int32 [S] straggler cells, then the int32 [2] counts
// (count, overflow; zeroed by the classify kernel); out: like in; mini:
// [Q, nz, nyb, ocap, nlane]; order: 0 (1 and 2 are the checks' controls).
extern "C" int uammd_sep_rebin(void* in, void* strag, void* scratch, void* out, void* mini,
                               int Q, int S, int nx, int nyb, int nz, int F, int cap,
                               int ocap, int order, float Lx, float Ly, float Lz, float iLx,
                               float iLy, float iLz, void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, rebin::cpad_of(cap), {Lx, Ly, Lz}, {iLx, iLy, iLz}};
  const int wide = cap + ocap;
  const size_t slots = static_cast<size_t>(nz) * nyb * wide * g.nlane;
  const size_t smem = pull_smem(wide, g.nlane, S);
  if ((Q != 7 && Q != 4) || nx < 3 || nz < 3 || nyb * F < 3 || cap < 1 || ocap < 0 ||
      S < 1 || S >= (1 << (31 - rebin::kLaneBits)) || g.nlane >= (1 << rebin::kLaneBits) ||
      order < 0 || order > 2 || g.nlane * (g.cpad / 16) > 1024 ||
      pull_threads(g.nlane) > 512 || smem > kMaxSmem ||
      static_cast<size_t>(Q) * slots >= (static_cast<size_t>(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto pull = Q == 7 ? sep_pull<7> : sep_pull<4>;
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
      static_cast<float*>(out), static_cast<float*>(mini), counts, ocap, order, g);
  return static_cast<int>(cudaGetLastError());
}

// The scratch bytes, and the pull kernel's dynamic shared memory and
// threads, for the wrapper's plan to check.
extern "C" long long uammd_sep_rebin_scratch(int nx, int nyb, int nz, int F, int cap, int S) {
  return static_cast<long long>(nz) * nyb * nx * F * rebin::cpad_of(cap) + 4LL * (S + 2);
}

extern "C" long long uammd_sep_rebin_smem(int cap, int ocap, int nlane, int S) {
  return static_cast<long long>(pull_smem(cap + ocap, nlane, S));
}

extern "C" int uammd_sep_rebin_threads(int nlane) { return pull_threads(nlane); }

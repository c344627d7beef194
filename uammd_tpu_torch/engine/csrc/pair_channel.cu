// 27-stencil channel transverser over a pair functor, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/pair_kernel.py:make_pair_channel_kernel
// (:293, pallas_call at :538): n_chan channels in, n_out sums out, periodic
// in z (or, through the _halo entries, the z-slab halo mode: no Lz shift),
// with the pair_fn chosen at compile time as a functor of
// channel_functors.cuh (PSE near field at 1 or 2 stacked 3-vectors, DPD,
// SPH density and force, LJ mixture and its masked form, the Poisson near
// field, the fused LJ radial force). Every home slot sums the functor's
// contributions over the CAP slots of exactly the 27 cells around it (its
// own cell included: each functor's r2 > eps test, or its zero
// displacement, drops the self pair). With a functor that serves
// stragglers (kStrag: PSE, Poisson, the radial force) the straggler list
// ([3 + NG + 1, S]:
// x, y, z, channels, valid; each direction's displacement rounded as for a
// grid candidate of an image cell, pse::image_pair) adds its forward
// contributions, and the rows' reverse contributions are reduced into
// spart [NOUT, S] (the JAX kernel returns per-program partials that its
// caller sums over (z, yb, lane)). In the halo mode the caller sums those
// partials over the slab's interior rows only (parallel/pse_dd2.py:344-347),
// so the home slots of the two ghost rows (z = 0 and z = nz - 1) add
// nothing to spart; their own outputs are dropped by the caller and left
// as the periodic mode leaves them. The other functors run on
// straggler-free specs (S = 0), as the JAX engines build them.
//
// Layout: arrays are [nz, nyb, CAP, NLANE] float32; lane l = cx*F + f is
// cell (cx, y = yb*F + f). A slot is empty iff x >= 5e8 (EMPTY_POS is 1e9;
// a NaN x counts as occupied). A cell's occupancy is read from the
// positions: its last occupied row + 1. No state field is needed.
//
// Non-finite coordinates: the JAX pair_fn (and the plain version) multiply
// a zero coefficient by the displacement outside the cutoff, so a pair
// whose displacement component d_k is NaN or infinite puts NaN into the
// sums that carry d_k (the functor's kDisp), in every home slot within the
// 27 cells of the coordinate, empty ones included. The kernel adds that
// 0 * d_k for every pair whose r2 is not finite (zero_terms), and writes
// NaN into those sums of the empty home slots whose 27 cells hold a
// non-finite coordinate (or, with stragglers, when a row does).
//
// What bounded the lane-per-cell design this replaces: one thread per home
// slot in blocks of (NLANE, rows), the 32 lanes of a warp in 32 cells, so
// every candidate loop ran over all 27 x CAP slots (432 evaluations a home
// slot for DPD's ~108 real candidates, 5832 for Poisson's ~3900), empty
// home slots held their lanes idle (75 % of DPD's, ~47 % of SPH's), a
// (z, yb) column was staged again for every block of `rows` home rows
// (4 to 13 times), and the functor's body ran under divergence for the
// few lanes inside the cutoff (~3 % of DPD's).
//
// Design:
// - A block is (z, yb, a rectangle of cc x fc cells along x and the fold)
//   and stages the rectangle with a one-cell halo, (cc + 2) x (fc + 2)
//   columns of CAP slots, for the three z layers, once, with cp.async
//   (4-byte copies: x, y, z into interleaved float4 slots; rows an odd
//   number of slots apart, so that the lanes' reads down a column fall on
//   distinct banks). The periodic image shift is added to the staged copy
//   of every wrapped column (x + shift rounded as the plain version rounds
//   it); the halo mode adds no Lz shift. The shape comes from the wrapper
//   (pair_kernel.channel_launch_plan), at least 2 x 132 blocks where the
//   grid has that many cells; above 48 KB of dynamic shared memory the
//   launch opts in with cudaFuncSetAttribute. A warp scans 32 / CAP
//   columns at once when CAP is at most 16.
// - Home side as chunks of occupied slots: the block lists its cells'
//   occupied home slots in cell order and cuts the list into chunks of at
//   most 32, one lane per slot; a cell of more than 32 slots takes several
//   chunks (Poisson: ~5), cells of a few share one (DPD: ~7 cells). The
//   block's warps loop over the chunks. Each lane keeps its own cell, walks
//   the union of its chunk's stencils and takes only the candidates of its
//   own 27 cells (an integer test on the column), so the sums stay exact: a
//   particle that drifted within the cutoff from a cell outside the stencil
//   is left out, as the plain version leaves it out. Empty home slots are
//   written apart (0, or NaN as above).
// - Occupancy-bounded walks with a cutoff cull: the chunk's walk over a
//   column stops at its occupancy; each lane first tests one candidate (32
//   at a time) against the bounding box of the chunk's home particles
//   grown by the functor's reach (and a 0.01 margin for rounding), and the
//   warp walks only those that pass, each a shared-memory broadcast. A
//   column with a non-finite coordinate, or a chunk with a non-finite home
//   particle, is walked whole, so that NaN lands where the plain version
//   puts it. For the mixtures the reach is sqrt(cs2) times the chunk's
//   largest half_sigma plus the block's staged largest.
// - Pairs in rounds: a walked candidate does not run the functor's body in
//   the lanes it is near (a few of 32); each such lane pushes the pair
//   (its lane, the candidate's staged and device indices) onto the warp's
//   ring of 128, and when 32 pairs wait the warp runs one round: each lane
//   takes one pair, reads its home's position (staged) and channels
//   (device memory) at the indices its home lane shuffles over, reads the
//   candidate's channels from device memory and runs the body. Each home
//   lane then finds its pairs in the round from five ballots on the
//   home-lane bits and adds their terms, fetched by shuffles, in ring
//   order (walk order). So a heavy body (DPD's hashes, Poisson's degree-20
//   Horner sums, PSE's) runs with 32 lanes busy, and the staged copy holds
//   positions only. The walk visits two candidates at a time. Each pair's
//   term is rounded as before; only the order of a home slot's sums
//   changed.
// - Straggler rows (Poisson, PSE): the block culls the list once against
//   its home box (each row's nearest images), keeps the forward terms in
//   registers, reduces the reverse terms over the warp with shuffles and
//   adds them with one atomicAdd per warp and row. Rows with a non-finite
//   coordinate, and every row in a block with a non-finite home particle,
//   are kept.
//
// What bounds it now (phase builds and a counting build on the card,
// PERF.md section 6): instruction issue in the walk, about 30
// instructions a candidate visit (two broadcast loads, the displacements
// and r2 rounded without FMA, the stencil and threshold tests, two ballots
// and the ring pushes) at 1.5-2 instructions a cycle an SM, over chunks x
// candidates walked: about half the time at the SPH and DPD paths'
// states; then the rounds and, for DPD, the setup (CAP 16 columns, three
// quarters empty, staged and scanned: a third of its time). The lanes of a
// multi-cell chunk outside a walked column's stencil (DPD: 12.6 of 28) are
// the waste left. Registers and spills of each instantiation: ptxas -v,
// printed by chip_smoke.py (the cap of __launch_bounds__(512, 2) is 64).

#include <cfloat>
#include <cstddef>
#include <type_traits>

#include "channel_functors.cuh"

namespace {

constexpr int kMaxWarps = 16;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxCells = 64;  // home cells of a block
constexpr int kLayers = 3;     // dz = -1, 0, 1
constexpr int kRing = 128;     // a warp's pairs waiting for a round (a power of 2)
constexpr int kHdr = 16;       // a block's scalars in shared memory
constexpr float kEmptyX = 5.0e8f;  // a slot is empty iff x >= kEmptyX
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the opt-in limit of sm_90

struct Geom {
  int nx, nyb, nz, F, cap, nlane;
  float Lx, Ly, Lz, iLx, iLy, iLz;  // iL = float32(1 / L), the straggler minimum image's
  int periodic_z;  // 0: z-slab halo mode, the z index wraps but takes no Lz shift
  int cc, fc;      // the block's cells along x and along the fold
  int occ_trim;    // 0; 1 stops every candidate loop one row short (a control)
};

// staged columns of a block: its cc x fc cells with a one-cell halo,
// column = cxr * (fc + 2) + fyr
__host__ __device__ inline int window(int cc, int fc) { return (cc + 2) * (fc + 2); }

// warps of a block: the chunks its cells should give. The mean occupancy
// is estimated from CAP as cap^2 / (cap + 48) (CAP is the occupancy's high
// quantile); cells below 27 pack into chunks of ~26 lanes, larger ones take
// ceil(mean / 32) chunks each. The warps loop over the chunks, however
// many a state gives.
__host__ __device__ inline int warps_of(int cap, int cc, int fc) {
  const int cells = cc * fc;
  int m = cap * cap / (cap + 48);
  m = m < 1 ? 1 : m;
  const int w = m <= 26 ? (cells * m + 25) / 26 : cells * ((m + 31) / 32);
  return w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : w);
}

// dynamic shared memory: float4 pos[3][cap][R] (rows R = W | 1 apart),
// float4 shift[3][W]; per warp int2 ring[128] and float box[8]; int
// base/occ/bad[3][W], int cnt[cells], list[cells][cap],
// chunk[cells * ceil(cap / 32) + 1], hdr[16], float srow[ng + 4][S],
// int keep[S]
size_t smem_bytes(int cap, int cc, int fc, int ng, int S) {
  const size_t w = window(cc, fc);
  const size_t cells = static_cast<size_t>(cc) * fc;
  const size_t npc = (cap + 31) / 32;
  return kLayers * static_cast<size_t>(cap) * (w | 1) * 16 + kLayers * w * (16 + 12) +
         4 * cells * (1 + cap) + 4 * (cells * npc + 1 + kHdr) +
         static_cast<size_t>(8 * kRing + 32) * warps_of(cap, cc, fc) +
         4 * static_cast<size_t>(ng + 5) * S;
}

// float <-> int keeping the order of non-NaN floats, for int min/max
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ int wrap(int s, int n) { return ((s % n) + n) % n; }

__device__ __forceinline__ float image(int s, int n, float L) {
  return s < 0 ? -L : (s >= n ? L : 0.0f);
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The plain version's term of a pair outside the cutoff whose displacement
// is not finite: its zero coefficient times d, in the sums that carry d.
template <class Fn>
__device__ __forceinline__ void zero_terms(float dx, float dy, float dz, float* acc) {
  if constexpr (Fn::kDisp == 1) {
    acc[0] += 0.0f * dx;
    acc[1] += 0.0f * dy;
    acc[2] += 0.0f * dz;
  } else if constexpr (Fn::kDisp == 2) {
    const float t = 0.0f * ((dx + dy) + dz);
#pragma unroll
    for (int k = 0; k < Fn::NOUT; ++k) acc[k] += t;
  }
}

// Whether sum k of an empty home slot is NaN, given the non-finite
// coordinates (bits x, y, z) among its candidates.
template <class Fn>
__device__ __forceinline__ bool nan_sum(int k, unsigned bits) {
  if (Fn::kDisp == 1) return k < 3 && ((bits >> k) & 1u);
  if (Fn::kDisp == 2) return bits != 0;
  return false;
}

// distance from v to [lo, hi], over v's images v - L, v, v + L
__device__ __forceinline__ float image_gap(float v, float lo, float hi, float L) {
  float e = fmaxf(fmaxf(lo - v, v - hi), 0.0f);
  e = fminf(e, fmaxf(fmaxf(lo - (v - L), (v - L) - hi), 0.0f));
  return fminf(e, fmaxf(fmaxf(lo - (v + L), (v + L) - hi), 0.0f));
}

template <class Fn>
__global__ void __launch_bounds__(kMaxThreads, 2) pair_channel_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ z,
    const float* __restrict__ ch, const float* __restrict__ uni,
    const float* __restrict__ strag, float* __restrict__ out, float* __restrict__ spart,
    Geom g, Fn fn, int S) {
  constexpr int NG = Fn::NG;
  constexpr int NU = Fn::NU;
  constexpr int NO = Fn::NOUT;
  extern __shared__ float4 smem4[];
  const int W = window(g.cc, g.fc);
  const int R = W | 1;  // the row stride of pos
  const int fw = g.fc + 2;
  const int ncell = g.cc * g.fc;
  const int npc = (g.cap + 31) >> 5;
  const int LR = g.cap * R;  // one layer of pos
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float4* pos = smem4;                                             // [3][cap][R]
  float4* shift = pos + kLayers * LR;                              // [3][W]
  int2* wring = reinterpret_cast<int2*>(shift + kLayers * W);      // [warps][kRing]
  float* wbox = reinterpret_cast<float*>(wring + kRing * nwarps);  // [warps][8]
  int* base = reinterpret_cast<int*>(wbox + 8 * nwarps);           // [3][W]
  int* occ = base + kLayers * W;                                   // [3][W]
  int* bad = occ + kLayers * W;                                    // [3][W]
  int* cnt = bad + kLayers * W;         // [cells]: occupied home slots, then list offsets
  int* list = cnt + ncell;              // [cells * cap]: (cell << 16) | row
  int* chunk = list + ncell * g.cap;    // [cells * npc + 1]: list offsets
  int* hdr = chunk + ncell * npc + 1;   // [kHdr]
  float* srow = reinterpret_cast<float*>(hdr + kHdr);              // [NG + 4][S]
  int* keep = reinterpret_cast<int*>(srow + (NG + 4) * S);         // [S]
  // hdr: 0 chunks, 1 the largest half_sigma in the window (ordered), 2 rows
  // kept, 3 a home particle not finite, 4 the rows' non-finite coordinates
  // (bits), 5-10 the box of the finite home particles (ordered min x y z,
  // max x y z)

  const int ncx = (g.nx + g.cc - 1) / g.cc;
  const int cx0 = (blockIdx.x % ncx) * g.cc;
  const int f0 = (blockIdx.x / ncx) * g.fc;
  const int yb = blockIdx.y;
  const int zc = blockIdx.z;
  const int ny = g.nyb * g.F;
  const int plane = g.cap * g.nlane;  // one [CAP, NLANE] block
  const size_t T = static_cast<size_t>(g.nz) * g.nyb * plane;
  const int Ti = static_cast<int>(T);  // the launch checks that T fits
  const size_t blk = (static_cast<size_t>(zc) * g.nyb + yb) * plane;
  const float inf = __int_as_float(0x7f800000);

  // 1. where each staged column comes from, and its image shift
  for (int lc = tid; lc < kLayers * W; lc += blockDim.x) {
    const int layer = lc / W;
    const int col = lc - layer * W;
    const int cxr = col / fw;
    const int cx = cx0 - 1 + cxr;
    const int cy = yb * g.F + f0 - 1 + (col - cxr * fw);
    const int sz = zc + layer - 1;
    shift[lc] = make_float4(image(cx, g.nx, g.Lx), image(cy, ny, g.Ly),
                            g.periodic_z ? image(sz, g.nz, g.Lz) : 0.0f, 0.0f);
    const int wy = wrap(cy, ny);
    const int syb = wy / g.F;
    base[lc] = (wrap(sz, g.nz) * g.nyb + syb) * plane + wrap(cx, g.nx) * g.F + (wy - syb * g.F);
  }
  for (int c = tid; c < ncell; c += blockDim.x) cnt[c] = 0;
  if (tid < kHdr) {
    hdr[tid] = tid < 5 ? 0 : (tid < 8 ? ordered(inf) : (tid < 11 ? ordered(-inf) : 0));
  }
  __syncthreads();

  // 2. stage every column's CAP slots, x y z into one float4 each; the
  // straggler rows
  for (int e = tid; e < kLayers * g.cap * W; e += blockDim.x) {
    const int lr = e / W;  // layer * cap + row
    const int col = e - lr * W;
    const int layer = lr / g.cap;
    const size_t src = static_cast<size_t>(base[layer * W + col]) +
                       static_cast<size_t>(lr - layer * g.cap) * g.nlane;
    float* dst = reinterpret_cast<float*>(pos + lr * R + col);
    cp_async4(dst, x + src);
    cp_async4(dst + 1, y + src);
    cp_async4(dst + 2, z + src);
  }
  if constexpr (Fn::kStrag) {
    for (int e = tid; e < (NG + 4) * S; e += blockDim.x) srow[e] = strag[e];
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. per column (G lanes each: a warp takes 32 / G columns when CAP is
  // at most 16): occupancy, the non-finite coordinates (bits x, y, z) among
  // its occupied slots, the image shift added; the home columns' counts
  // and box; the largest half_sigma in the window
  {
    const int G = g.cap > 16 ? 32 : (g.cap > 8 ? 16 : 8);
    const int per = 32 / G;
    const int sub = lane / G;
    const int rl = lane - sub * G;
    const unsigned seg = G == 32 ? kFull : ((1u << G) - 1u) << (sub * G);
    for (int lc0 = warp * per; lc0 < kLayers * W; lc0 += nwarps * per) {
      const int lc = lc0 + sub;
      const bool colok = lc < kLayers * W;
      const int layer = lc / W;
      const int col = lc - layer * W;
      const int cxr = col / fw;
      const int fr = col - cxr * fw;
      const bool homecol = colok && layer == 1 && cxr >= 1 && cxr <= g.cc && fr >= 1 &&
                           fr <= g.fc && cx0 + cxr - 1 < g.nx && f0 + fr - 1 < g.F;
      const float4 sh = colok ? shift[lc] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const bool shifted = sh.x != 0.0f || sh.y != 0.0f || sh.z != 0.0f;
      float4* colp = pos + layer * LR + col;
      int n = 0, nocc = 0;
      unsigned nonfinite = 0;
      float hs = 0.0f;
      float b0x = inf, b0y = inf, b0z = inf, b1x = -inf, b1y = -inf, b1z = -inf;
      for (int r0 = 0; r0 < g.cap; r0 += G) {
        const int r = r0 + rl;
        bool here = false;
        bool bx = false, by = false, bz = false;
        if (colok && r < g.cap) {
          float4 p = colp[r * R];
          here = !(p.x >= kEmptyX);
          bx = here && !isfinite(p.x);
          by = here && !isfinite(p.y);
          bz = here && !isfinite(p.z);
          if (shifted) {
            p.x = __fadd_rn(p.x, sh.x);
            p.y = __fadd_rn(p.y, sh.y);
            p.z = __fadd_rn(p.z, sh.z);
            colp[r * R] = p;
          }
          if constexpr (Fn::kReachChan >= 0) {
            if (here) {
              hs = fmaxf(hs, ch[Fn::kReachChan * T + static_cast<size_t>(base[lc]) +
                                static_cast<size_t>(r) * g.nlane]);
            }
          }
          if (Fn::kStrag && homecol && here && !(bx || by || bz)) {
            b0x = fminf(b0x, p.x);
            b0y = fminf(b0y, p.y);
            b0z = fminf(b0z, p.z);
            b1x = fmaxf(b1x, p.x);
            b1y = fmaxf(b1y, p.y);
            b1z = fmaxf(b1z, p.z);
          }
        }
        const unsigned m = __ballot_sync(kFull, here) & seg;
        if (m) n = r0 + 32 - __clz(m) - sub * G;
        nocc += __popc(m);
        nonfinite |= ((__ballot_sync(kFull, bx) & seg) ? 1u : 0u) |
                     ((__ballot_sync(kFull, by) & seg) ? 2u : 0u) |
                     ((__ballot_sync(kFull, bz) & seg) ? 4u : 0u);
      }
      if constexpr (Fn::kReachChan >= 0) {
        const int m = __reduce_max_sync(seg, ordered(hs));
        if (rl == 0) atomicMax(hdr + 1, m);
      }
      if constexpr (Fn::kStrag) {
        if (homecol) {
          const int m0x = __reduce_min_sync(seg, ordered(b0x));
          const int m0y = __reduce_min_sync(seg, ordered(b0y));
          const int m0z = __reduce_min_sync(seg, ordered(b0z));
          const int m1x = __reduce_max_sync(seg, ordered(b1x));
          const int m1y = __reduce_max_sync(seg, ordered(b1y));
          const int m1z = __reduce_max_sync(seg, ordered(b1z));
          if (rl == 0) {
            atomicMin(hdr + 5, m0x);
            atomicMin(hdr + 6, m0y);
            atomicMin(hdr + 7, m0z);
            atomicMax(hdr + 8, m1x);
            atomicMax(hdr + 9, m1y);
            atomicMax(hdr + 10, m1z);
            if (nonfinite) hdr[3] = 1;
          }
        }
      }
      if (rl == 0 && colok) {
        occ[lc] = n;
        bad[lc] = static_cast<int>(nonfinite);
        if (homecol) cnt[(cxr - 1) * g.fc + fr - 1] = nocc;
      }
    }
  }
  __syncthreads();

  // 4. the chunks (thread 0), and the straggler rows this block keeps (its
  // last warp)
  if (tid == 0) {
    int off = 0, nch = 0, fill = 32;  // fill: lanes of the open chunk (32: none open)
    for (int c = 0; c < ncell; ++c) {
      const int n = cnt[c];
      cnt[c] = off;
      if (n > 32) {  // a large cell: chunks of its own
        for (int k = 0; k < n; k += 32) chunk[nch++] = off + k;
        fill = 32;
      } else if (n > 0) {
        if (fill + n > 32) {
          chunk[nch++] = off;
          fill = 0;
        }
        fill += n;
      }
      off += n;
    }
    chunk[nch] = off;
    hdr[0] = nch;
  }
  if constexpr (Fn::kStrag) {
    if (warp == nwarps - 1) {
      const bool all_rows = hdr[3] != 0;
      const float cut = fn.reach(0.0f) + 1.0e-2f;
      const float lo[3] = {unordered(hdr[5]), unordered(hdr[6]), unordered(hdr[7])};
      const float hi[3] = {unordered(hdr[8]), unordered(hdr[9]), unordered(hdr[10])};
      const float L[3] = {g.Lx, g.Ly, g.Lz};
      int nk = 0;
      unsigned sbad = 0;
      for (int s0 = 0; s0 < S; s0 += 32) {
        const int s = s0 + lane;
        bool kept = false;
        if (s < S) {
          float e2 = 0.0f;
          unsigned bits = 0;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float v = srow[a * S + s];
            bits |= isfinite(v) ? 0u : (1u << a);
            const float e = image_gap(v, lo[a], hi[a], L[a]);
            e2 += e * e;
          }
          sbad |= bits;
          kept = all_rows || bits != 0 || (srow[(NG + 3) * S + s] > 0.5f && e2 < cut * cut);
        }
        const unsigned m = __ballot_sync(kFull, kept);
        if (kept) keep[nk + __popc(m & ((1u << lane) - 1u))] = s;
        nk += __popc(m);
      }
      sbad = __reduce_or_sync(kFull, sbad);
      if (lane == 0) {
        hdr[2] = nk;
        hdr[4] = static_cast<int>(sbad);
      }
    }
  }
  __syncthreads();

  // 5. the home list (one warp per cell), and the empty home slots' sums:
  // each term is 0 * d, NaN only in the sums whose displacement is not
  // finite for some candidate
  for (int c = warp; c < ncell; c += nwarps) {
    const int cxl = c / g.fc;
    const int fl = c - cxl * g.fc;
    if (cx0 + cxl >= g.nx || f0 + fl >= g.F) continue;
    const int hcol = (cxl + 1) * fw + fl + 1;
    unsigned nf = Fn::kStrag ? static_cast<unsigned>(hdr[4]) : 0u;
    for (int layer = 0; layer < kLayers; ++layer)
      for (int dyi = 0; dyi < 3; ++dyi)
        for (int dxi = 0; dxi < 3; ++dxi)
          nf |= static_cast<unsigned>(bad[layer * W + (cxl + dxi) * fw + fl + dyi]);
    const size_t hl = blk + static_cast<size_t>(cx0 + cxl) * g.F + f0 + fl;
    const float nan = __int_as_float(0x7fc00000);
    int off = cnt[c];
    for (int r0 = 0; r0 < g.cap; r0 += 32) {
      const int r = r0 + lane;
      const bool inrow = r < g.cap;
      const bool here = inrow && !(pos[LR + r * R + hcol].x >= kEmptyX);
      const unsigned m = __ballot_sync(kFull, here);
      if (here) list[off + __popc(m & ((1u << lane) - 1u))] = (c << 16) | r;
      off += __popc(m);
      if (inrow && !here) {
        const size_t hidx = hl + static_cast<size_t>(r) * g.nlane;
#pragma unroll
        for (int k = 0; k < NO; ++k) out[k * T + hidx] = nan_sum<Fn>(k, nf) ? nan : 0.0f;
      }
    }
  }
  __syncthreads();

  // 6. one warp per chunk of occupied home slots
  float cu[NU > 0 ? NU : 1];
#pragma unroll
  for (int k = 0; k < NU; ++k) cu[k] = uni[k];
  float* box = wbox + 8 * warp;
  int2* ring = wring + kRing * warp;
  const unsigned below = (1u << lane) - 1u;  // the lanes below this one
  const int nch = hdr[0];
  for (int ck = warp; ck < nch; ck += nwarps) {
    const int e0 = chunk[ck];
    const int e1 = chunk[ck + 1];
    const bool live = e0 + lane < e1;
    int cell = 0, row = 0;
    if (live) {
      const int v = list[e0 + lane];
      cell = v >> 16;
      row = v & 0xffff;
    }
    const int hx = cell / g.fc;
    const int hf = cell - hx * g.fc;
    // the home slot in device memory and in the staged layer 1 (the rounds
    // read the home channels from there, not from registers)
    const int hidx = static_cast<int>(blk) + row * g.nlane + (cx0 + hx) * g.F + f0 + hf;
    const int hoff = LR + row * R + (hx + 1) * fw + hf + 1;
    const float4 h = live ? pos[hoff] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const bool fin = isfinite(h.x) && isfinite(h.y) && isfinite(h.z);
    const bool in_box = live && fin;
    // the box of the chunk's finite home particles, in shared memory (the
    // lanes read it once per 32 candidates)
    {
      const int b0x = __reduce_min_sync(kFull, ordered(in_box ? h.x : inf));
      const int b0y = __reduce_min_sync(kFull, ordered(in_box ? h.y : inf));
      const int b0z = __reduce_min_sync(kFull, ordered(in_box ? h.z : inf));
      const int b1x = __reduce_max_sync(kFull, ordered(in_box ? h.x : -inf));
      const int b1y = __reduce_max_sync(kFull, ordered(in_box ? h.y : -inf));
      const int b1z = __reduce_max_sync(kFull, ordered(in_box ? h.z : -inf));
      if (lane == 0) {
        box[0] = unordered(b0x);
        box[1] = unordered(b0y);
        box[2] = unordered(b0z);
        box[3] = unordered(b1x);
        box[4] = unordered(b1y);
        box[5] = unordered(b1z);
      }
      __syncwarp();
    }
    // the union of the lanes' stencils, in window columns
    const int wx0 = __reduce_min_sync(kFull, live ? hx : 1 << 20);
    const int wx1 = __reduce_max_sync(kFull, live ? hx : -1) + 2;
    const int wf0 = __reduce_min_sync(kFull, live ? hf : 1 << 20);
    const int wf1 = __reduce_max_sync(kFull, live ? hf : -1) + 2;
    // the mixtures' reach: the chunk's largest half_sigma plus the window's
    // for the cull, the lane's own plus the window's for its threshold
    float hs = 0.0f, hs_lane = 0.0f;
    if constexpr (Fn::kReachChan >= 0) {
      const float hw = unordered(hdr[1]);
      const float hs_i = live ? ch[Fn::kReachChan * Ti + hidx] : 0.0f;
      hs = unordered(__reduce_max_sync(kFull, ordered(hs_i))) + hw;
      hs_lane = hs_i + hw;
    }
    const float cut = fn.reach(hs) + 1.0e-2f;
    const float cut2 = cut * cut;
    const float thr = fn.thr2(hs_lane);
    // a candidate left out is finite and beyond the reach of every home
    // particle, so each of its terms is 0 (empty slots' too)
    const bool cull = __all_sync(kFull, !live || fin) && cut2 <= FLT_MAX;
    float acc[NO];
#pragma unroll
    for (int k = 0; k < NO; ++k) acc[k] = 0.0f;
    int head = 0, tail = 0;  // the pairs run and found so far (the same in every lane)

    // A round: the n <= 32 pairs ring[head, head + n), one a lane, each
    // term computed with its home lane's data (shuffled over). Each home
    // lane then finds its pairs from five ballots on the home lanes' bits
    // and adds their terms in ring order, which is walk order.
    auto round = [&](int n) {
      __syncwarp();
      const bool has = lane < n;
      const int2 e = has ? ring[(head + lane) & (kRing - 1)] : make_int2(0, 0);
      const int owner = (e.x >> 16) & 31;
      const int ho = __shfl_sync(kFull, hoff, owner);
      const int hi = __shfl_sync(kFull, hidx, owner);
      float t[NO];
#pragma unroll
      for (int k = 0; k < NO; ++k) t[k] = 0.0f;
      if (has) {
        float hc[NG + NU > 0 ? NG + NU : 1];
#pragma unroll
        for (int k = 0; k < NG; ++k) hc[k] = ch[k * Ti + hi];
#pragma unroll
        for (int k = 0; k < NU; ++k) hc[NG + k] = cu[k];
        const float4 hp = pos[ho];
        const float4 p = pos[e.x & 0xffff];
        const float dxv = p.x - hp.x;
        const float dyv = p.y - hp.y;
        const float dzv = p.z - hp.z;
        if (e.x & (1 << 21)) {
          zero_terms<Fn>(dxv, dyv, dzv, t);
        } else {
          fn.fwd(pse::dist2(dxv, dyv, dzv), dxv, dyv, dzv, hc, ch + e.y, Ti, t);
        }
      }
      head += n;
      unsigned own = __ballot_sync(kFull, has);
#pragma unroll
      for (int b = 0; b < 5; ++b) {
        const unsigned bit = __ballot_sync(kFull, has && ((owner >> b) & 1));
        own &= ((lane >> b) & 1) ? bit : ~bit;
      }
      const int rounds = __reduce_max_sync(kFull, __popc(own));
      for (int r = 0; r < rounds; ++r) {
        const int src = own ? __ffs(own) - 1 : lane;
#pragma unroll
        for (int k = 0; k < NO; ++k) {
          const float v = __shfl_sync(kFull, t[k], src);
          if (own) acc[k] += v;
        }
        own &= own - 1;
      }
    };
    // candidates a and b (staged indices oa, ob; slots ga, gb in device
    // memory; b only when `two`), the same for every lane, against the
    // lanes whose stencil holds them: the pairs inside thr2 (and, where a
    // walk is whole, those whose r2 is not finite) go to the ring, a's
    // before b's
    auto visit2 = [&](int oa, int ga, int ob, int gb, bool two, bool mine, auto whole) {
      const float4 pa = pos[oa];
      const float4 pb = pos[ob];
      const float ax = pa.x - h.x;
      const float ay = pa.y - h.y;
      const float az = pa.z - h.z;
      const float bx = pb.x - h.x;
      const float by = pb.y - h.y;
      const float bz = pb.z - h.z;
      const float ra = pse::dist2(ax, ay, az);
      const float rb = pse::dist2(bx, by, bz);
      bool na = false, nb = false;
      if constexpr (decltype(whole)::value) {
        na = !(ra <= FLT_MAX);
        nb = two && !(rb <= FLT_MAX);
      }
      const bool push_a = mine && (ra < thr || na);
      const bool push_b = mine && two && (rb < thr || nb);
      const unsigned ma = __ballot_sync(kFull, push_a);
      const unsigned mb = __ballot_sync(kFull, push_b);
      const int ca = __popc(ma);
      if (push_a) {
        ring[(tail + __popc(ma & below)) & (kRing - 1)] =
            make_int2(oa | (lane << 16) | (na ? 1 << 21 : 0), ga);
      }
      if (push_b) {
        ring[(tail + ca + __popc(mb & below)) & (kRing - 1)] =
            make_int2(ob | (lane << 16) | (nb ? 1 << 21 : 0), gb);
      }
      tail += ca + __popc(mb);
      while (tail - head >= 32) round(32);
    };

    for (int layer = 0; layer < kLayers; ++layer) {
      for (int wx = wx0; wx <= wx1; ++wx) {
        for (int wf = wf0; wf <= wf1; ++wf) {
          const bool mine = live && static_cast<unsigned>(wx - hx) <= 2u &&
                            static_cast<unsigned>(wf - hf) <= 2u;
          if (!__any_sync(kFull, mine)) continue;
          const int lc = layer * W + wx * fw + wf;
          const int n = occ[lc] - g.occ_trim;
          const int o0 = layer * LR + wx * fw + wf;  // row 0 of the column
          const int g0 = base[lc];                   // its slot in device memory
          if (cull && bad[lc] == 0) {
            for (int j0 = 0; j0 < n; j0 += 32) {
              bool pass = false;
              if (j0 + lane < n) {
                const float4 p = pos[o0 + (j0 + lane) * R];
                const float ex = fmaxf(fmaxf(box[0] - p.x, p.x - box[3]), 0.0f);
                const float ey = fmaxf(fmaxf(box[1] - p.y, p.y - box[4]), 0.0f);
                const float ez = fmaxf(fmaxf(box[2] - p.z, p.z - box[5]), 0.0f);
                pass = ex * ex + ey * ey + ez * ez < cut2;
              }
              unsigned b = __ballot_sync(kFull, pass);
              while (b) {
                const int ja = j0 + __ffs(b) - 1;
                b &= b - 1;
                const bool two = b != 0;
                const int jb = two ? j0 + __ffs(b) - 1 : ja;
                b &= b - 1;
                visit2(o0 + ja * R, g0 + ja * g.nlane, o0 + jb * R, g0 + jb * g.nlane, two,
                       mine, std::false_type());
              }
            }
          } else {
            for (int j = 0; j < n; j += 2) {
              const bool two = j + 1 < n;
              const int jb = two ? j + 1 : j;
              visit2(o0 + j * R, g0 + j * g.nlane, o0 + jb * R, g0 + jb * g.nlane, two, mine,
                     std::true_type());
            }
          }
        }
      }
    }
    while (tail > head) round(min(32, tail - head));

    if constexpr (Fn::kStrag) {
      // a ghost row's home slots add nothing to spart (halo mode)
      const bool ghost = !g.periodic_z && (zc == 0 || zc == g.nz - 1);
      float ci[NG > 0 ? NG : 1];
#pragma unroll
      for (int k = 0; k < NG; ++k) ci[k] = live ? ch[k * T + hidx] : 0.0f;
      const int nk = hdr[2];
      for (int t = 0; t < nk; ++t) {
        const int s = keep[t];
        const bool valid = srow[(NG + 3) * S + s] > 0.5f;
        float rev[NO];
#pragma unroll
        for (int k = 0; k < NO; ++k) rev[k] = 0.0f;
        bool any = false;
        if (live) {
          float d[3], e[3];  // onto the home slot, onto the row
          pse::image_pair(srow[s], h.x, g.Lx, g.iLx, &d[0], &e[0]);
          pse::image_pair(srow[S + s], h.y, g.Ly, g.iLy, &d[1], &e[1]);
          pse::image_pair(srow[2 * S + s], h.z, g.Lz, g.iLz, &d[2], &e[2]);
          float Fj[NG > 0 ? NG : 1];
#pragma unroll
          for (int k = 0; k < NG; ++k) Fj[k] = srow[(3 + k) * S + s];
          const float r2 = pse::dist2(d[0], d[1], d[2]);
          const float r2e = pse::dist2(e[0], e[1], e[2]);
          // an invalid row is the plain version's r2 = 1e18: 0 * d
          if (valid && r2 <= FLT_MAX) {
            fn.fwd(r2, d[0], d[1], d[2], ci, Fj, 1, acc);
          } else {
            zero_terms<Fn>(d[0], d[1], d[2], acc);
          }
          if (ghost) {
            // nothing to add
          } else if (valid && r2e <= FLT_MAX) {
            fn.fwd(r2e, e[0], e[1], e[2], Fj, ci, 1, rev);
          } else {
            zero_terms<Fn>(e[0], e[1], e[2], rev);
          }
#pragma unroll
          for (int k = 0; k < NO; ++k) any |= rev[k] != 0.0f || rev[k] != rev[k];
        }
        if (!__any_sync(kFull, any)) continue;  // outside the cutoff: no atomics
#pragma unroll
        for (int k = 0; k < NO; ++k) {
          float v = rev[k];
#pragma unroll
          for (int sh = 16; sh > 0; sh >>= 1) v += __shfl_xor_sync(kFull, v, sh);
          if (lane == 0) atomicAdd(spart + k * S + s, v);
        }
      }
    }

    if (live) {
#pragma unroll
      for (int k = 0; k < NO; ++k) out[k * T + hidx] = acc[k];
    }
  }
}

template <class Fn>
int launch(const float* x, const float* y, const float* z, const float* ch, const float* uni,
           const float* strag, float* out, float* spart, const Geom& g, const Fn& fn, int S,
           cudaStream_t st) {
  const size_t smem = smem_bytes(g.cap, g.cc, g.fc, Fn::NG, S);
  const size_t T = static_cast<size_t>(g.nz) * g.nyb * g.cap * g.nlane;
  const int nch = Fn::NG > Fn::NOUT ? Fn::NG : Fn::NOUT;
  if (g.cc < 1 || g.fc < 1 || g.cc * g.fc > kMaxCells || g.cc > g.nx || g.fc > g.F ||
      g.cap < 1 || g.cap > 65535 || g.occ_trim < 0 || S < 0 || (S > 0 && !Fn::kStrag) ||
      smem > kMaxSmem || T * nch >= (static_cast<size_t>(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static size_t enabled = 0;  // dynamic shared memory allowed so far
  if (smem > enabled) {
    cudaError_t e = cudaFuncSetAttribute(pair_channel_kernel<Fn>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(pair_channel_kernel<Fn>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    enabled = smem;
  }
  const int ncx = (g.nx + g.cc - 1) / g.cc;
  const int ncf = (g.F + g.fc - 1) / g.fc;
  const dim3 grid(ncx * ncf, g.nyb, g.nz);
  const dim3 block(32 * warps_of(g.cap, g.cc, g.fc));
  pair_channel_kernel<Fn><<<grid, block, smem, st>>>(x, y, z, ch, uni, strag, out, spart, g,
                                                      fn, S);
  return static_cast<int>(cudaGetLastError());
}

Geom geom(int nx, int nyb, int nz, int F, int cap, float Lx, float Ly, float Lz, float iLx,
          float iLy, float iLz, int periodic_z, int cc, int fc, int occ_trim) {
  return Geom{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, iLx, iLy, iLz,
              periodic_z, cc, fc, occ_trim};
}

template <class Fn>
int launch_plain(void* x, void* y, void* z, void* ch, void* uni, void* out, int nx, int nyb,
                 int nz, int F, int cap, int cc, int fc, int occ_trim, float Lx, float Ly,
                 float Lz, const Fn& fn, void* stream, int periodic_z) {
  return launch<Fn>(static_cast<const float*>(x), static_cast<const float*>(y),
                    static_cast<const float*>(z), static_cast<const float*>(ch),
                    static_cast<const float*>(uni), nullptr, static_cast<float*>(out), nullptr,
                    geom(nx, nyb, nz, F, cap, Lx, Ly, Lz, 0.0f, 0.0f, 0.0f, periodic_z, cc, fc,
                         occ_trim),
                    fn, 0, static_cast<cudaStream_t>(stream));
}

// The PSE near field at nv = 1 or 2 stacked 3-vectors, periodic in z or in
// the halo mode (periodic_z 0).
int pse_launch(void* x, void* y, void* z, void* ch, void* strag, void* out, void* spart, int nv,
               int nx, int nyb, int nz, int F, int cap, int S, int cc, int fc, int occ_trim,
               float Lx, float Ly, float Lz, float iLx, float iLy, float iLz,
               const pse::Near& p, void* stream, int periodic_z) {
  const Geom g =
      geom(nx, nyb, nz, F, cap, Lx, Ly, Lz, iLx, iLy, iLz, periodic_z, cc, fc, occ_trim);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(x);
  const float* fy = static_cast<const float*>(y);
  const float* fz = static_cast<const float*>(z);
  const float* fc_ = static_cast<const float*>(ch);
  const float* fs = static_cast<const float*>(strag);
  float* fo = static_cast<float*>(out);
  float* fp = static_cast<float*>(spart);
  if (nv == 1) return launch(fx, fy, fz, fc_, nullptr, fs, fo, fp, g, chan::PSEFn<1>{p}, S, st);
  if (nv == 2) return launch(fx, fy, fz, fc_, nullptr, fs, fo, fp, g, chan::PSEFn<2>{p}, S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A straggler-serving functor: ch float32 [NG, T]; strag [3 + NG + 1, S] or
// null when S == 0; out [NOUT, T]; spart [NOUT, S], zeroed.
template <class Fn>
int strag_launch(void* x, void* y, void* z, void* ch, void* strag, void* out, void* spart,
                 int nx, int nyb, int nz, int F, int cap, int S, int cc, int fc, int occ_trim,
                 float Lx, float Ly, float Lz, float iLx, float iLy, float iLz, const Fn& fn,
                 void* stream, int periodic_z) {
  return launch(static_cast<const float*>(x), static_cast<const float*>(y),
                static_cast<const float*>(z), static_cast<const float*>(ch), nullptr,
                static_cast<const float*>(strag), static_cast<float*>(out),
                static_cast<float*>(spart),
                geom(nx, nyb, nz, F, cap, Lx, Ly, Lz, iLx, iLy, iLz, periodic_z, cc, fc,
                     occ_trim),
                fn, S, static_cast<cudaStream_t>(stream));
}

}  // namespace

// cc, fc: the block's cells along x and the fold (pair_kernel.channel_launch_plan);
// occ_trim: 0 (1 only for a check's control).
//
// PSE near field. ch: float32 [3 nv, T]; strag: float32 [3 + 3 nv + 1, S]
// or null when S == 0; out: [3 nv, T]; spart: [3 nv, S], zeroed.
extern "C" int uammd_pair_channel(void* x, void* y, void* z, void* ch, void* strag, void* out,
                                  void* spart, int nv, int nx, int nyb, int nz, int F, int cap,
                                  int S, int cc, int fc, int occ_trim, float Lx, float Ly,
                                  float Lz, float iLx, float iLy, float iLz, pse::Near p,
                                  void* stream) {
  return pse_launch(x, y, z, ch, strag, out, spart, nv, nx, nyb, nz, F, cap, S, cc, fc,
                    occ_trim, Lx, Ly, Lz, iLx, iLy, iLz, p, stream, 1);
}

// The same in the z-slab halo mode of parallel/pse_dd.py and pse_dd2.py
// (pair_kernel.py:381-385, periodic_z=False): x, y, z are a slab extended by
// one image-shifted ghost row at each end; the z index wraps but takes no Lz
// shift; spart sums the interior rows' reverse terms only. The straggler
// minimum image still takes the box's L in all three axes.
extern "C" int uammd_pair_channel_halo(void* x, void* y, void* z, void* ch, void* strag,
                                       void* out, void* spart, int nv, int nx, int nyb, int nz,
                                       int F, int cap, int S, int cc, int fc, int occ_trim,
                                       float Lx, float Ly, float Lz, float iLx, float iLy,
                                       float iLz, pse::Near p, void* stream) {
  return pse_launch(x, y, z, ch, strag, out, spart, nv, nx, nyb, nz, F, cap, S, cc, fc,
                    occ_trim, Lx, Ly, Lz, iLx, iLy, iLz, p, stream, 0);
}

// The straggler-free functors: ch float32 [NG, T] (the grid channels),
// uni float32 [NU] on the card (the uniform channels) or null, out [NOUT, T].
// Each has a twin NAME_halo, the z-slab halo mode of parallel/domain.py
// (pair_kernel.py:300, periodic_z=False): the z index wraps but takes no Lz
// shift; the caller passes a slab extended by image-shifted ghost rows and
// drops their outputs.
#define UAMMD_PAIR_CHANNEL_ENTRY(NAME, FN, PARAMS)                                             \
  extern "C" int NAME(void* x, void* y, void* z, void* ch, void* uni, void* out, int nx,       \
                      int nyb, int nz, int F, int cap, int cc, int fc, int occ_trim, float Lx,  \
                      float Ly, float Lz, PARAMS p, void* stream) {                            \
    return launch_plain(x, y, z, ch, uni, out, nx, nyb, nz, F, cap, cc, fc, occ_trim, Lx, Ly,  \
                        Lz, FN{p}, stream, 1);                                                 \
  }                                                                                            \
  extern "C" int NAME##_halo(void* x, void* y, void* z, void* ch, void* uni, void* out,        \
                             int nx, int nyb, int nz, int F, int cap, int cc, int fc,          \
                             int occ_trim, float Lx, float Ly, float Lz, PARAMS p,             \
                             void* stream) {                                                   \
    return launch_plain(x, y, z, ch, uni, out, nx, nyb, nz, F, cap, cc, fc, occ_trim, Lx, Ly,  \
                        Lz, FN{p}, stream, 0);                                                 \
  }

UAMMD_PAIR_CHANNEL_ENTRY(uammd_pair_channel_dpd, chan::DPDFn, chan::DPDParams)
UAMMD_PAIR_CHANNEL_ENTRY(uammd_pair_channel_sph_density, chan::SPHDensityFn, chan::SPHParams)
UAMMD_PAIR_CHANNEL_ENTRY(uammd_pair_channel_sph_force, chan::SPHForceFn, chan::SPHParams)
UAMMD_PAIR_CHANNEL_ENTRY(uammd_pair_channel_lj_mix, chan::LJMixFn<false>, chan::LJMixParams)
UAMMD_PAIR_CHANNEL_ENTRY(uammd_pair_channel_lj_mix_masked, chan::LJMixFn<true>,
                         chan::LJMixParams)

// The Poisson near field, with the straggler rows: ch float32 [1, T] (the
// charges); strag float32 [5, S] (x, y, z, charge, valid) or null when
// S == 0; out [4, T]; spart [4, S], zeroed.
extern "C" int uammd_pair_channel_poisson(void* x, void* y, void* z, void* ch, void* strag,
                                          void* out, void* spart, int nx, int nyb, int nz,
                                          int F, int cap, int S, int cc, int fc, int occ_trim,
                                          float Lx, float Ly, float Lz, float iLx, float iLy,
                                          float iLz, chan::PoissonParams p, void* stream) {
  return strag_launch(x, y, z, ch, strag, out, spart, nx, nyb, nz, F, cap, S, cc, fc, occ_trim,
                      Lx, Ly, Lz, iLx, iLy, iLz, chan::PoissonFn{p}, stream, 1);
}

// The fused LJ radial force g(r2) d of parallel/pse_dd2.py:115-127 (no
// channels, 3 sums, both directions over the straggler rows): ch unused
// (any pointer); strag [4, S] (x, y, z, valid) or null when S == 0; out
// [3, T]; spart [3, S], zeroed. _halo: the z-slab halo mode, as
// uammd_pair_channel_halo.
extern "C" int uammd_pair_channel_radial(void* x, void* y, void* z, void* ch, void* strag,
                                         void* out, void* spart, int nx, int nyb, int nz, int F,
                                         int cap, int S, int cc, int fc, int occ_trim, float Lx,
                                         float Ly, float Lz, float iLx, float iLy, float iLz,
                                         chan::RadialParams p, void* stream) {
  return strag_launch(x, y, z, ch, strag, out, spart, nx, nyb, nz, F, cap, S, cc, fc, occ_trim,
                      Lx, Ly, Lz, iLx, iLy, iLz, chan::RadialForceFn{p}, stream, 1);
}

extern "C" int uammd_pair_channel_radial_halo(void* x, void* y, void* z, void* ch, void* strag,
                                              void* out, void* spart, int nx, int nyb, int nz,
                                              int F, int cap, int S, int cc, int fc,
                                              int occ_trim, float Lx, float Ly, float Lz,
                                              float iLx, float iLy, float iLz,
                                              chan::RadialParams p, void* stream) {
  return strag_launch(x, y, z, ch, strag, out, spart, nx, nyb, nz, F, cap, S, cc, fc, occ_trim,
                      Lx, Ly, Lz, iLx, iLy, iLz, chan::RadialForceFn{p}, stream, 0);
}

// The dynamic shared memory and the threads of one block, for the wrapper's
// plan to check: ng grid channels, S straggler rows (0 without).
extern "C" long long uammd_pair_channel_smem(int cap, int cc, int fc, int ng, int S) {
  return static_cast<long long>(smem_bytes(cap, cc, fc, ng, S));
}

extern "C" int uammd_pair_channel_threads(int cap, int cc, int fc) {
  return 32 * warps_of(cap, cc, fc);
}

// Newton-halved channel transverser with the PSE near-field functor, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/kernel2.py:make_newton_channel_kernel
// (pallas_call at :992) with pair_both_fn = the PSE near-field RPY remainder
// (pse_engine.py:_pair_fn, device form in pse_near.cuh), NV = 1 or 2
// stacked 3-vectors (3 or 6 channels in and out). Each unordered pair of
// cells is visited once:
//   - the home cell: every ordered pair, forward only (as the JAX kernel);
//   - the 13 positive offsets POS_OFFSETS: forward onto the home slot, and
//     the reverse contribution onto the candidate's own slot (its row and
//     lane) of home when the candidate lies in the home (z, y-block), else
//     of reaction group G_g, g the candidate block's displacement in
//     REACTION_GROUPS = ((1,-1), (1,0), (1,1), (0,1)), stored at the HOME
//     block index: the fold (fold.cu, uammd_fold_n) adds G_g[z - dz, yb - dyb];
//   - the straggler list ([3 + 3 NV + 1, S]: x, y, z, channels, valid), a
//     candidate of every home slot, each direction's displacement rounded
//     as for a grid candidate of an image cell (pse::image_pair):
//     forward onto the home slot, reverse reduced into spart [3 NV, S]
//     (the JAX kernel returns per-program partials that its caller sums
//     over (z, yb, lane)).
// raw = [5, 3 NV, T] (home, then the groups in REACTION_GROUPS order) and
// spart are zeroed by the caller.
//
// What bounded the lane-per-slot design this replaces: one thread per home
// slot in blocks of 4 home rows x NLANE lanes, so each of a (z, yb)'s 8
// blocks staged the whole 2 x 3-y-block neighbourhood again, 3 rows at a
// time (22 passes, 44 barriers, ~360 MB of L2 traffic a launch); every
// thread walked all CAP rows of its 14 cells (the near grid is 63 % full)
// and all S = 192 straggler rows twice; and every reverse pair went out
// through 3 NV float atomicAdds to device memory.
//
// Design (the shape of pair_channel.cu, #2, made Newton-halved):
// - A block is (z, yb, a rectangle of cc x fc cells along x and the fold)
//   and stages, once, the positions of the rectangle with a one-cell halo,
//   (cc + 2) x (fc + 2) columns of CAP slots, in the two z layers its
//   offsets reach (z and z + 1), with cp.async; the periodic image shift is
//   added to the staged copy of every wrapped column.
// - Home side as chunks of occupied slots (one lane a slot, up to 32, cells
//   of a few sharing one, a larger cell several), one warp a cell (at most
//   10). Each lane keeps its own cell and takes, from the union of its
//   chunk's stencils, only its own cell's columns: the self cell (forward
//   only) and the 13 positive offsets. The walk over a column stops at its
//   occupancy (the last occupied row + 1, read from the positions) and
//   culls the candidates against the chunk's home box grown by rcut (+ 0.01
//   for rounding). The chunk's home channels sit in a per-warp table in
//   shared memory, not in registers (the kernel is register-bound).
// - Pairs in rounds: the pairs inside rcut wait on the warp's ring of 128
//   and run 32 at a time, one a lane (radial, then the forward terms, then
//   the reverse ones). The forward terms go to their home lanes by five
//   ballots and shuffles (as in #2), into registers. A walked candidate
//   pushes its pairs contiguously, so the reverse terms are summed over
//   each candidate's run of the round with a segmented shuffle scan (as
//   many steps as the round's longest run needs: 2-3 of 5 at the PSE grid,
//   where a candidate has ~3 partners), and the run's last lane adds the
//   sum into the block's reverse table in shared memory [3 NV][2
//   layers][CAP][window] (shared float atomics, CAS loops on sm_90: two
//   warps of the block may meet a candidate at once).
// - Straggler rows: the block culls the list once against its home box
//   (each row's nearest images); the forward terms stay in registers, the
//   reverse terms are reduced over the warp and added to spart with one
//   atomicAdd a warp and kept row.
// - At the end each home lane adds its forward sum into the table at its
//   own slot, and the block adds every nonzero entry of the table to raw:
//   one global atomic a block and entry, where the design this replaces
//   made 3 NV a pair. They stay atomics because the windows of
//   neighbouring blocks overlap on their halo columns, so an entry takes
//   sums from up to four blocks. (A design without the table, each run's
//   sum added straight to raw, ran 1.2-1.6x slower on the card.) Not
//   bit-equal between calls: the adds' order varies.
// - A non-finite coordinate (in the window or the straggler rows) makes the
//   block walk densely, as the plain version sums: every row of every home
//   cell (empty slots too), every candidate row, every straggler row, no
//   cull, and a pair whose r2 is not finite adds 0 x d to both sums. So NaN
//   lands where newton_channel_plain puts it.
// Launch plan (kernel2.newton_channel_plan): at the PSE grid [19, 3, 32,
// 114] blocks of 5 x 2 cells, 320 threads, 69 KB (3 channels) and 95 KB (6)
// of shared memory, two blocks an SM, 684 blocks. Registers and spills:
// ptxas -v, printed by chip_smoke.py (95-96 registers under
// __launch_bounds__(320, 2), no spill; at 12 warps a block the cap is 80,
// ptxas spilled 20-60 bytes, and 4 x 3 blocks ran ~4 % faster).
//
// What bounds it: neither instruction throughput nor memory. The operations
// (radial and both directions' terms for the pairs inside rcut, the cutoff
// test for each candidate pair) bound it at ~0.01 ms; phase builds on the
// card put about half of the time in the walk and staging, and the rest in
// the rounds (forward and reverse about equally), at ~1.5 instructions a
// cycle an SM: latency-bound at 20 warps an SM, the register limit.

#include <cfloat>
#include <cstddef>

#include "pse_near.cuh"

namespace {

constexpr int kMaxWarps = 10;  // with two blocks an SM: 96 registers a thread, no spill
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxCells = 64;  // home cells of a block
constexpr int kLayers = 2;     // dz = 0, 1
constexpr int kRing = 128;     // a warp's pairs waiting for a round (a power of 2)
constexpr int kHdr = 16;       // a block's scalars in shared memory
constexpr float kEmptyX = 5.0e8f;  // a slot is empty iff x >= kEmptyX
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the opt-in limit of sm_90
constexpr int kSelf = 1 << 22;       // ring flag: a self-cell pair, forward only
constexpr int kWhole = 1 << 21;      // ring flag: r2 not finite, add 0 x d

struct Geom {
  int nx, nyb, nz, F, cap, nlane;
  float Lx, Ly, Lz, iLx, iLy, iLz;  // iL = float32(1 / L), the straggler minimum image's
  int cc, fc;    // the block's cells along x and along the fold
  int occ_trim;  // 0; 1 stops every candidate loop one row short (a control)
};

__host__ __device__ inline int window(int cc, int fc) { return (cc + 2) * (fc + 2); }

// warps of a block: one a cell, at most 10 (a chunk is about a cell at the
// PSE grid's occupancy, ~20 of CAP 32)
__host__ __device__ inline int warps_of(int cap, int cc, int fc) {
  const int cells = cc * fc;
  return cells < kMaxWarps ? cells : kMaxWarps;
}

// dynamic shared memory: float4 pos[2][cap][R] (R = W | 1), float4
// shift[2][W]; per warp int2 ring[128], float box[8] and its chunk's home
// channels float hch[32][nc]; float
// racc[nc][2][cap][W]; int base/occ/bad[2][W], cnt[cells],
// list[cells][cap], chunk[cells * ceil(cap / 32) + 1], hdr[16]; int
// keep[S] (the straggler rows stay in device memory)
size_t smem_bytes(int cap, int cc, int fc, int nc, int S) {
  const size_t w = window(cc, fc);
  const size_t cells = static_cast<size_t>(cc) * fc;
  const size_t npc = (cap + 31) / 32;
  return kLayers * static_cast<size_t>(cap) * (w | 1) * 16 + kLayers * w * 16 +
         static_cast<size_t>(8 * kRing + 32 + 128 * nc) * warps_of(cap, cc, fc) +
         4 * static_cast<size_t>(nc) * kLayers * cap * w + kLayers * w * 12 +
         4 * cells * (1 + cap) + 4 * (cells * npc + 1 + kHdr) +
         4 * static_cast<size_t>(S);
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

// distance from v to [lo, hi], over v's images v - L, v, v + L
__device__ __forceinline__ float image_gap(float v, float lo, float hi, float L) {
  float e = fmaxf(fmaxf(lo - v, v - hi), 0.0f);
  e = fminf(e, fmaxf(fmaxf(lo - (v - L), (v - L) - hi), 0.0f));
  return fminf(e, fmaxf(fmaxf(lo - (v + L), (v + L) - hi), 0.0f));
}

// The plain version's term of a pair outside the cutoff whose displacement
// is not finite (or an invalid straggler row): its zero coefficient times
// d, which every sum carries (PSENear.disp 2).
template <int NC>
__device__ __forceinline__ void zero_terms(float dx, float dy, float dz, float* acc) {
  const float t = 0.0f * ((dx + dy) + dz);
#pragma unroll
  for (int k = 0; k < NC; ++k) acc[k] += t;
}

template <int NV>
__global__ void __launch_bounds__(kMaxThreads, 2) newton_channel_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ z,
    const float* __restrict__ ch, const float* __restrict__ strag, float* __restrict__ raw,
    float* __restrict__ spart, Geom g, pse::Near p, int S) {
  constexpr int NC = 3 * NV;
  extern __shared__ float4 smem4[];
  const int W = window(g.cc, g.fc);
  const int R = W | 1;  // the row stride of pos
  const int fw = g.fc + 2;
  const int ncell = g.cc * g.fc;
  const int npc = (g.cap + 31) >> 5;
  const int LR = g.cap * R;       // one layer of pos
  const int NE = kLayers * g.cap * W;  // entries of the reverse table
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float4* pos = smem4;                                             // [2][cap][R]
  float4* shift = pos + kLayers * LR;                              // [2][W]
  int2* wring = reinterpret_cast<int2*>(shift + kLayers * W);      // [warps][kRing]
  float* wbox = reinterpret_cast<float*>(wring + kRing * nwarps);  // [warps][8]
  float* whch = wbox + 8 * nwarps;                                 // [warps][32][nc]
  float* racc = whch + 32 * NC * nwarps;                           // [nc][NE]
  int* base = reinterpret_cast<int*>(racc + NC * NE);              // [2][W]
  int* occ = base + kLayers * W;                                   // [2][W]
  int* bad = occ + kLayers * W;                                    // [2][W]
  int* cnt = bad + kLayers * W;       // [cells]: home slots, then list offsets
  int* list = cnt + ncell;            // [cells * cap]: (cell << 16) | row
  int* chunk = list + ncell * g.cap;  // [cells * npc + 1]: list offsets
  int* hdr = chunk + ncell * npc + 1;  // [kHdr]
  int* keep = hdr + kHdr;                                          // [S]
  const float* srow = strag;  // [nc + 4][S], read where it is (rows are few)
  // hdr: 0 chunks, 2 rows kept, 3 dense (a coordinate in the window or the
  // rows is not finite), 5-10 the box of the home particles (ordered min
  // x y z, max x y z)

  const int ncx = (g.nx + g.cc - 1) / g.cc;
  const int cx0 = (blockIdx.x % ncx) * g.cc;
  const int f0 = (blockIdx.x / ncx) * g.fc;
  const int yb = blockIdx.y;
  const int zc = blockIdx.z;
  const int ny = g.nyb * g.F;
  const int plane = g.cap * g.nlane;  // one [CAP, NLANE] block
  const int T = g.nz * g.nyb * plane;  // the launch checks that NC x T fits
  const int blk = (zc * g.nyb + yb) * plane;
  const float inf = __int_as_float(0x7f800000);

  // 1. where each staged column comes from, and its image shift; the
  // tables zeroed
  for (int lc = tid; lc < kLayers * W; lc += blockDim.x) {
    const int layer = lc / W;
    const int col = lc - layer * W;
    const int cxr = col / fw;
    const int cx = cx0 - 1 + cxr;
    const int cy = yb * g.F + f0 - 1 + (col - cxr * fw);
    const int sz = zc + layer;
    shift[lc] = make_float4(image(cx, g.nx, g.Lx), image(cy, ny, g.Ly), image(sz, g.nz, g.Lz),
                            0.0f);
    const int wy = wrap(cy, ny);
    const int syb = wy / g.F;
    base[lc] = (wrap(sz, g.nz) * g.nyb + syb) * plane + wrap(cx, g.nx) * g.F + (wy - syb * g.F);
  }
  for (int e = tid; e < NC * NE; e += blockDim.x) racc[e] = 0.0f;
  for (int c = tid; c < ncell; c += blockDim.x) cnt[c] = 0;
  if (tid < kHdr) {
    hdr[tid] = tid < 5 ? 0 : (tid < 8 ? ordered(inf) : (tid < 11 ? ordered(-inf) : 0));
  }
  __syncthreads();

  // 2. stage every column's CAP slots, x y z into one float4 each
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
  cp_async_wait_all();
  __syncthreads();

  // 3. per column (G lanes each: a warp takes 32 / G columns when CAP is
  // at most 16): occupancy, the non-finite coordinates among its occupied
  // slots, the image shift added; the home columns' counts and box; a
  // straggler row that is not finite
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
      const bool homecol = colok && layer == 0 && cxr >= 1 && cxr <= g.cc && fr >= 1 &&
                           fr <= g.fc && cx0 + cxr - 1 < g.nx && f0 + fr - 1 < g.F;
      const float4 sh = colok ? shift[lc] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const bool shifted = sh.x != 0.0f || sh.y != 0.0f || sh.z != 0.0f;
      float4* colp = pos + layer * LR + col;
      int n = 0, nocc = 0;
      bool nonfinite = false;
      float b0x = inf, b0y = inf, b0z = inf, b1x = -inf, b1y = -inf, b1z = -inf;
      for (int r0 = 0; r0 < g.cap; r0 += G) {
        const int r = r0 + rl;
        bool here = false, nf = false;
        if (colok && r < g.cap) {
          float4 p4 = colp[r * R];
          here = !(p4.x >= kEmptyX);
          nf = here && !(isfinite(p4.x) && isfinite(p4.y) && isfinite(p4.z));
          if (shifted) {
            p4.x = __fadd_rn(p4.x, sh.x);
            p4.y = __fadd_rn(p4.y, sh.y);
            p4.z = __fadd_rn(p4.z, sh.z);
            colp[r * R] = p4;
          }
          if (homecol && here && !nf) {
            b0x = fminf(b0x, p4.x);
            b0y = fminf(b0y, p4.y);
            b0z = fminf(b0z, p4.z);
            b1x = fmaxf(b1x, p4.x);
            b1y = fmaxf(b1y, p4.y);
            b1z = fmaxf(b1z, p4.z);
          }
        }
        const unsigned m = __ballot_sync(kFull, here) & seg;
        if (m) n = r0 + 32 - __clz(m) - sub * G;
        nocc += __popc(m);
        nonfinite |= (__ballot_sync(kFull, nf) & seg) != 0;
      }
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
        }
      }
      if (rl == 0 && colok) {
        occ[lc] = n;
        bad[lc] = nonfinite ? 1 : 0;
        if (nonfinite) hdr[3] = 1;
        if (homecol) cnt[(cxr - 1) * g.fc + fr - 1] = nocc;
      }
    }
  }
  for (int e = tid; e < 3 * S; e += blockDim.x) {
    if (!isfinite(srow[e])) hdr[3] = 1;
  }
  __syncthreads();
  const bool dense = hdr[3] != 0;

  // 4. the chunks (thread 0), the straggler rows this block keeps (its last
  // warp); a dense block walks every row of every column
  if (dense) {
    for (int lc = tid; lc < kLayers * W; lc += blockDim.x) occ[lc] = g.cap;
  }
  if (tid == 0) {
    int off = 0, nch = 0, fill = 32;  // fill: lanes of the open chunk (32: none open)
    for (int c = 0; c < ncell; ++c) {
      const int cxl = c / g.fc;
      const bool real = cx0 + cxl < g.nx && f0 + (c - cxl * g.fc) < g.F;
      const int n = !real ? 0 : (dense ? g.cap : cnt[c]);
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
  if (warp == nwarps - 1) {
    const float cut = sqrtf(p.rc2) + 1.0e-2f;
    const float lo[3] = {unordered(hdr[5]), unordered(hdr[6]), unordered(hdr[7])};
    const float hi[3] = {unordered(hdr[8]), unordered(hdr[9]), unordered(hdr[10])};
    const float L[3] = {g.Lx, g.Ly, g.Lz};
    int nk = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      bool kept = false;
      if (s < S) {
        float e2 = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float e = image_gap(srow[a * S + s], lo[a], hi[a], L[a]);
          e2 += e * e;
        }
        kept = dense || (srow[(NC + 3) * S + s] > 0.5f && e2 < cut * cut);
      }
      const unsigned m = __ballot_sync(kFull, kept);
      if (kept) keep[nk + __popc(m & ((1u << lane) - 1u))] = s;
      nk += __popc(m);
    }
    if (lane == 0) hdr[2] = nk;
  }
  __syncthreads();

  // 5. the home list (one warp per cell): its occupied rows, or in a dense
  // block every row
  for (int c = warp; c < ncell; c += nwarps) {
    const int cxl = c / g.fc;
    const int fl = c - cxl * g.fc;
    if (cx0 + cxl >= g.nx || f0 + fl >= g.F) continue;
    const int hcol = (cxl + 1) * fw + fl + 1;
    int off = cnt[c];
    for (int r0 = 0; r0 < g.cap; r0 += 32) {
      const int r = r0 + lane;
      const bool here = r < g.cap && (dense || !(pos[r * R + hcol].x >= kEmptyX));
      const unsigned m = __ballot_sync(kFull, here);
      if (here) list[off + __popc(m & ((1u << lane) - 1u))] = (c << 16) | r;
      off += __popc(m);
    }
  }
  __syncthreads();

  // 6. one warp per chunk of home slots
  float* box = wbox + 8 * warp;
  float* hch = whch + 32 * NC * warp;  // the chunk's home channels, by lane
  int2* ring = wring + kRing * warp;
  const unsigned below = (1u << lane) - 1u;  // the lanes below this one
  const int nch = hdr[0];
  const float cut = sqrtf(p.rc2) + 1.0e-2f;
  const float cut2 = cut * cut;
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
    // the home slot in device memory and in the staged layer 0
    const int hidx = blk + row * g.nlane + (cx0 + hx) * g.F + f0 + hf;
    const int hcol = (hx + 1) * fw + hf + 1;
    const int hoff = row * R + hcol;
    const float4 h = live ? pos[hoff] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // the home channels, which the rounds read by home lane (in shared
    // memory, not registers: the walk and the rounds are register-bound)
#pragma unroll
    for (int k = 0; k < NC; ++k) hch[lane * NC + k] = live ? ch[k * T + hidx] : 0.0f;
    float acc[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[k] = 0.0f;
    {
      const bool in_box = live && h.x < kEmptyX;
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
    int head = 0, tail = 0;  // the pairs run and found so far (the same in every lane)

    // A round: the n <= 32 pairs ring[head, head + n), one a lane. The
    // forward terms go to their home lanes (five ballots on the home lanes'
    // bits, then shuffles in ring order); the reverse terms of each
    // candidate's run are summed by a segmented scan and the run's last lane
    // adds them to the reverse table.
    auto round = [&](int n) {
      __syncwarp();
      const bool has = lane < n;
      const int2 e = has ? ring[(head + lane) & (kRing - 1)] : make_int2(0, 0);
      const int owner = (e.x >> 16) & 31;
      const int ho = __shfl_sync(kFull, hoff, owner);
      const bool self = (e.x & kSelf) != 0;
      const bool whole = (e.x & kWhole) != 0;
      const int cand = e.x & 0xffff;
      // the candidate's channels, loaded first: their latency overlaps the
      // radial
      float Fj[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) Fj[k] = has ? ch[k * T + e.y] : 0.0f;
      float dxv = 0.0f, dyv = 0.0f, dzv = 0.0f, fr = 0.0f, gr = 0.0f;
      bool inside = false;
      if (has) {
        const float4 hp = pos[ho];
        const float4 cp = pos[cand];
        dxv = cp.x - hp.x;
        dyv = cp.y - hp.y;
        dzv = cp.z - hp.z;
        inside = !whole && pse::radial(pse::dist2(dxv, dyv, dzv), p, &fr, &gr);
      }
      head += n;
      // forward, then reverse: one direction's terms live at a time
      float t[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) t[k] = 0.0f;
      if (has && whole) {
        zero_terms<NC>(dxv, dyv, dzv, t);
      } else if (inside) {
        pse::apply<NV>(fr, gr, dxv, dyv, dzv, Fj, t);
      }
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
        for (int k = 0; k < NC; ++k) {
          const float v = __shfl_sync(kFull, t[k], src);
          if (own) acc[k] += v;
        }
        own &= own - 1;
      }
      // reverse, with the home's channels: a run is the lanes of one
      // candidate (self pairs and idle lanes are runs of their own)
      float Fi[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        Fi[k] = hch[owner * NC + k];
        t[k] = 0.0f;
      }
      if (has && !self && whole) {
        zero_terms<NC>(dxv, dyv, dzv, t);
      } else if (inside && !self) {
        pse::apply<NV>(fr, gr, dxv, dyv, dzv, Fi, t);
      }
      float* rev = t;
      const int key = has && !self ? cand : -1 - lane;
      // the scan's steps: to the round's longest run (a candidate has ~3
      // partners at the PSE grid, so 2-3 steps of 5)
      const int prevk = __shfl_up_sync(kFull, key, 1);
      const unsigned heads = __ballot_sync(kFull, lane == 0 || prevk != key);
      const int start = 31 - __clz(heads & ((2u << lane) - 1u));
      const int len = __reduce_max_sync(kFull, lane - start + 1);
      for (int d = 1; d < len; d <<= 1) {
        const int kk = __shfl_up_sync(kFull, key, d);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const float v = __shfl_up_sync(kFull, rev[k], d);
          if (lane >= d && kk == key) rev[k] += v;
        }
      }
      const int next = __shfl_down_sync(kFull, key, 1);
      if (has && !self && (lane == n - 1 || next != key)) {
        const int layer = cand / LR;
        const int rem = cand - layer * LR;
        const int crow = rem / R;
        const int entry = (layer * g.cap + crow) * W + (rem - crow * R);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          if (rev[k] != 0.0f || rev[k] != rev[k]) atomicAdd(racc + k * NE + entry, rev[k]);
        }
      }
    };
    // candidates a and b (staged indices oa, ob; slots ga, gb in device
    // memory; b only when `two`), the same for every lane, against the
    // lanes whose stencil holds them (`mine`; `selfc`: the lane's own cell):
    // the pairs inside rcut (and, in a dense block, those whose r2 is not
    // finite) go to the ring, a's before b's
    auto visit2 = [&](int oa, int ga, int ob, int gb, bool two, bool mine, bool selfc) {
      const float4 pa = pos[oa];
      const float4 pb = pos[ob];
      const float ra = pse::dist2(pa.x - h.x, pa.y - h.y, pa.z - h.z);
      const float rb = pse::dist2(pb.x - h.x, pb.y - h.y, pb.z - h.z);
      const bool na = dense && !(ra <= FLT_MAX);
      const bool nb = dense && two && !(rb <= FLT_MAX);
      // (r2 <= 1e-10 has no term: the self pair and coincident particles)
      const bool push_a = mine && ((ra < p.rc2 && ra > 1e-10f) || na);
      const bool push_b = mine && two && ((rb < p.rc2 && rb > 1e-10f) || nb);
      const unsigned ma = __ballot_sync(kFull, push_a);
      const unsigned mb = __ballot_sync(kFull, push_b);
      const int ca = __popc(ma);
      const int flags = (lane << 16) | (selfc ? kSelf : 0);
      if (push_a) {
        ring[(tail + __popc(ma & below)) & (kRing - 1)] =
            make_int2(oa | flags | (na ? kWhole : 0), ga);
      }
      if (push_b) {
        ring[(tail + ca + __popc(mb & below)) & (kRing - 1)] =
            make_int2(ob | flags | (nb ? kWhole : 0), gb);
      }
      tail += ca + __popc(mb);
      while (tail - head >= 32) round(32);
    };

    for (int layer = 0; layer < kLayers; ++layer) {
      // layer 0: the self cell, dx = +1 at dy = 0, and dy = +1; layer 1:
      // every (dy, dx)
      for (int wx = wx0; wx <= wx1; ++wx) {
        for (int wf = wf0 + (layer == 0 ? 1 : 0); wf <= wf1; ++wf) {
          const int dxw = wx - hx;  // the column's dx + 1 from the lane's cell
          const int dfw = wf - hf;  // its dy + 1
          const bool inrange = live && static_cast<unsigned>(dxw) <= 2u &&
                               static_cast<unsigned>(dfw) <= 2u;
          const bool selfc = layer == 0 && dxw == 1 && dfw == 1;
          const bool mine = inrange && (layer == 1 || dfw == 2 || (dfw == 1 && dxw >= 1));
          if (!__any_sync(kFull, mine)) continue;
          const int lc = layer * W + wx * fw + wf;
          const int n = occ[lc] - g.occ_trim;
          const int o0 = layer * LR + wx * fw + wf;  // row 0 of the column
          const int g0 = base[lc];                   // its slot in device memory
          if (dense) {  // every row, two by two
            for (int j = 0; j < n; j += 2) {
              const bool two = j + 1 < n;
              const int jb = two ? j + 1 : j;
              visit2(o0 + j * R, g0 + j * g.nlane, o0 + jb * R, g0 + jb * g.nlane, two, mine,
                     selfc);
            }
            continue;
          }
          // 32 rows at a time: those inside the chunk's box grown by rcut,
          // two by two
          for (int j0 = 0; j0 < n; j0 += 32) {
            bool pass = false;
            if (j0 + lane < n) {
              const float4 q = pos[o0 + (j0 + lane) * R];
              const float ex = fmaxf(fmaxf(box[0] - q.x, q.x - box[3]), 0.0f);
              const float ey = fmaxf(fmaxf(box[1] - q.y, q.y - box[4]), 0.0f);
              const float ez = fmaxf(fmaxf(box[2] - q.z, q.z - box[5]), 0.0f);
              pass = ex * ex + ey * ey + ez * ez < cut2;
            }
            unsigned b = __ballot_sync(kFull, pass);
            while (b) {
              const int ja = j0 + __ffs(b) - 1;
              b &= b - 1;
              const bool two = b != 0;
              const int jb = two ? j0 + __ffs(b) - 1 : ja;
              b &= b - 1;
              visit2(o0 + ja * R, g0 + ja * g.nlane, o0 + jb * R, g0 + jb * g.nlane, two, mine,
                     selfc);
            }
          }
        }
      }
    }
    while (tail > head) round(min(32, tail - head));

    // the straggler rows this block keeps
    {
      const int nk = hdr[2];
      for (int t = 0; t < nk; ++t) {
        const int s = keep[t];
        const bool valid = srow[(NC + 3) * S + s] > 0.5f;
        float rev[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) rev[k] = 0.0f;
        bool any = false;
        if (live) {
          float d[3], e[3];  // onto the home slot, onto the row
          pse::image_pair(srow[s], h.x, g.Lx, g.iLx, &d[0], &e[0]);
          pse::image_pair(srow[S + s], h.y, g.Ly, g.iLy, &d[1], &e[1]);
          pse::image_pair(srow[2 * S + s], h.z, g.Lz, g.iLz, &d[2], &e[2]);
          const float r2 = pse::dist2(d[0], d[1], d[2]);
          const float r2e = pse::dist2(e[0], e[1], e[2]);
          float fr, gr;
          // an invalid row is the plain version's r2 = 1e18: 0 x d
          if (valid && r2 <= FLT_MAX) {
            if (pse::radial(r2, p, &fr, &gr)) {
              float Fj[NC];
#pragma unroll
              for (int k = 0; k < NC; ++k) Fj[k] = srow[(3 + k) * S + s];
              pse::apply<NV>(fr, gr, d[0], d[1], d[2], Fj, acc);
            }
          } else {
            zero_terms<NC>(d[0], d[1], d[2], acc);
          }
          if (valid && r2e <= FLT_MAX) {
            if (pse::radial(r2e, p, &fr, &gr)) {
              pse::apply<NV>(fr, gr, e[0], e[1], e[2], hch + lane * NC, rev);
            }
          } else {
            zero_terms<NC>(e[0], e[1], e[2], rev);
          }
#pragma unroll
          for (int k = 0; k < NC; ++k) any |= rev[k] != 0.0f || rev[k] != rev[k];
        }
        if (!__any_sync(kFull, any)) continue;  // outside the cutoff: nothing to add
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          float v = rev[k];
#pragma unroll
          for (int sh = 16; sh > 0; sh >>= 1) v += __shfl_xor_sync(kFull, v, sh);
          if (lane == 0) atomicAdd(spart + k * S + s, v);
        }
      }
    }

    // the forward sums, at the home slots' own entries (layer 0)
    if (live) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        atomicAdd(racc + k * NE + row * W + hcol, acc[k]);
      }
    }
  }
  __syncthreads();

  // 7. the tables to device memory: each entry (layer, row, window column)
  // is one slot of raw at this block's (z, yb) index: layer 0 in the home
  // y-block -> home, in the next -> group (0, 1); layer 1 in y-block
  // yb - 1, yb, yb + 1 -> groups (1, -1), (1, 0), (1, 1)
  for (int e = tid; e < NE; e += blockDim.x) {
    const int lr = e / W;
    const int col = e - lr * W;
    const int layer = lr / g.cap;
    const int r = lr - layer * g.cap;
    const int cxr = col / fw;
    const int cyr = f0 - 1 + (col - cxr * fw);  // the column's y from yb * F
    const int dyb = cyr < 0 ? -1 : (cyr >= g.F ? 1 : 0);
    const int grid = layer == 0 ? (dyb == 0 ? 0 : (dyb == 1 ? 4 : -1)) : 2 + dyb;
    if (grid < 0) continue;
    const int slot = blk + r * g.nlane + wrap(cx0 - 1 + cxr, g.nx) * g.F + (cyr - dyb * g.F);
    float* dst = raw + static_cast<size_t>(grid) * NC * T + slot;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const float v = racc[k * NE + e];
      if (v != 0.0f || v != v) atomicAdd(dst + static_cast<size_t>(k) * T, v);
    }
  }
}

template <int NV>
int launch(const float* x, const float* y, const float* z, const float* ch, const float* strag,
           float* raw, float* spart, const Geom& g, const pse::Near& p, int S, cudaStream_t st) {
  constexpr int NC = 3 * NV;
  const size_t smem = smem_bytes(g.cap, g.cc, g.fc, NC, S);
  const size_t T = static_cast<size_t>(g.nz) * g.nyb * g.cap * g.nlane;
  if (g.cc < 1 || g.fc < 1 || g.cc * g.fc > kMaxCells || g.cc > g.nx || g.fc > g.F ||
      g.cap < 1 || g.occ_trim < 0 || S < 0 || smem > kMaxSmem ||
      2 * g.cap * (window(g.cc, g.fc) | 1) > 65535 ||
      T * 5 * NC >= (static_cast<size_t>(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static size_t enabled = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > enabled) {
    cudaError_t e = cudaFuncSetAttribute(newton_channel_kernel<NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(newton_channel_kernel<NV>,
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
  newton_channel_kernel<NV><<<grid, block, smem, st>>>(x, y, z, ch, strag, raw, spart, g, p, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ch: float32 [3 nv, T]; strag: float32 [3 + 3 nv + 1, S] or null when
// S == 0; raw: [5, 3 nv, T] and spart: [3 nv, S], both zeroed; cc, fc: the
// block's cells along x and the fold (kernel2.newton_channel_plan);
// occ_trim: 0 (1 only for a check's control).
extern "C" int uammd_newton_channel(void* x, void* y, void* z, void* ch, void* strag, void* raw,
                                    void* spart, int nv, int nx, int nyb, int nz, int F, int cap,
                                    int S, int cc, int fc, int occ_trim, float Lx, float Ly,
                                    float Lz, float iLx, float iLy, float iLz, pse::Near p,
                                    void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, iLx, iLy, iLz, cc, fc, occ_trim};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(x);
  const float* fy = static_cast<const float*>(y);
  const float* fz = static_cast<const float*>(z);
  const float* fc_ = static_cast<const float*>(ch);
  const float* fs = static_cast<const float*>(strag);
  float* fr = static_cast<float*>(raw);
  float* fp = static_cast<float*>(spart);
  if (nv == 1) return launch<1>(fx, fy, fz, fc_, fs, fr, fp, g, p, S, st);
  if (nv == 2) return launch<2>(fx, fy, fz, fc_, fs, fr, fp, g, p, S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory and the threads of one block, for the wrapper's
// plan to check: nc = 3 nv channels, S straggler rows (0 without).
extern "C" long long uammd_newton_channel_smem(int cap, int cc, int fc, int nc, int S) {
  return static_cast<long long>(smem_bytes(cap, cc, fc, nc, S));
}

extern "C" int uammd_newton_channel_threads(int cap, int cc, int fc) {
  return 32 * warps_of(cap, cc, fc);
}

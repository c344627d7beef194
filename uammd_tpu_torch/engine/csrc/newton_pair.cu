// Newton's-third-law LJ pair force with straggler rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/kernel2.py:make_newton_pair_kernel
// (:58, pallas_call at :447), with the radial uammd_tpu/engine/md.py:lj_g_fused.
// Each unordered pair of cells is visited once: the home cell itself and the
// 13 positive offsets POS_OFFSETS = (1, dy, dx) for all dy, dx, (0, 1, dx)
// for all dx, and (0, 0, 1). The force on the home slot accumulates in
// registers; the reaction on the candidate is added to the candidate's own
// slot (row and lane) of
//   - home, when the candidate lies in the home (z, y-block),
//   - else group G_g with g the candidate block's displacement (dz, dyb) in
//     REACTION_GROUPS = ((1,-1), (1,0), (1,1), (0,1)), stored at the HOME
//     block index, so that the fold adds G_g[z - dz, yb - dyb] to f[z, yb].
// Stragglers ([4, S]: x, y, z, valid) are candidates of every home slot;
// their reactions are reduced straight into sforce [S, 3]. All outputs are
// zeroed by the caller: out = [15, nz, nyb, CAP, NLANE] (home x, y, z, then
// the groups in REACTION_GROUPS order, x, y, z each), sforce = [S, 3].
// self_half: the home cell's pairs are taken once (candidate row > home
// row) with the reaction added into home; off, every ordered pair of the
// home cell gives its forward term only (kernel2.py:836-845).
// cellcenter: stragglers are min-imaged once against the home cell centre
// (kernel2.py:314-352) instead of per pair (:353-378).
// Halo mode (entry uammd_newton_pair_halo, kernel2.py:74-134 halo_z=True):
// the z-slab of parallel/domain2.py; the top home row takes its dz = +1
// candidates from the caller's ghost row instead of row 0 + Lz
// (instantiated apart: kHalo).
//
// Why this design: with one thread per home slot and the 128 lanes of a warp
// in 128 different cells, every candidate loop runs over all CAP rows (32
// at the 2^20 v2 spec [42, 10, 32, 128], against a mean occupancy of
// 19.5), blocks of a few home rows stage each (z, yb) column's candidates
// again and again, and each pair inside the cutoff sends its reaction to
// global memory as 3 scattered float atomicAdds (~5.2e7 a call).
//
// Design: one warp per cell, one lane per home slot (a second pass of the
// warp for a cell of more than 32 slots). A slot is empty iff x >= 5e8
// (EMPTY_POS is 1e9); a cell's count is its last occupied row + 1, read
// from the positions; lanes past it carry a NaN position that fails every
// test. Every lane of a warp meets the same candidate slot j (a shared
// memory broadcast) and the trip count is the candidate cell's count, so
// there is no padding on the candidate side. Before that walk each lane
// tests one candidate (32 at a time) against the bounding box of the
// warp's home particles, and the warp walks only the candidates within the
// cutoff (and a 0.01 margin) of the box: by the cell geometry about 45 %
// of them at the 2^20 spec, where a quarter of all candidates have any lane
// inside the cutoff (measured: 24.6 %). Pairs at r2 = 0 (two empty slots)
// add g * 0 = 0. The reaction on j is skipped when the warp's ballot finds
// no pair inside; else it is one shuffle per component when a single lane
// is inside, or a warp sum (three sums in five shuffle rounds), and lane j
// keeps it in registers until the candidate cell is done; then each lane
// adds its candidate's sum, once, into a shared tile of the staged
// candidates' reactions (shared float atomics are compare-and-swap loops on
// sm_90, so one per slot and cell, not one per pair).
// A block is (z, yb, a rectangle of cc x fc cells along x and the fold),
// one warp per cell (at most 16); it stages its rectangle with a one-cell
// halo, (cc + 2) x (fc + 2) columns of CAP slots, for dz = 0 and dz = 1
// (the 5 candidate tiles of the old design: the home y-block, and the three
// y-blocks of the slab above, all in one window), once, with cp.async
// (4-byte copies into interleaved float4 slots, rows an odd number of
// slots apart), with the periodic image shift added to the staged copy of
// every wrapped column. Not double-buffered inside a block: every warp's
// cell needs both layers, and the 2 blocks that fit on an SM (64 registers
// a thread; 68 KB of shared memory each at the 2^20 spec) overlap one
// block's copies with the other's arithmetic. The home force stays in
// registers and goes into the same shared tile at its own slot. After a
// block barrier the tile is flushed once, with global atomicAdds of its
// nonzero slots (coalesced runs of fc + 2 lanes): the halo columns are also
// the neighbouring blocks' home columns, so a block is not the only writer
// of its target slots and the caller's zero fill stays. Stragglers are held
// in shared memory, and each block keeps only those within the cutoff (and
// a margin) of the bounding box of its home particles: at the PSE grid
// (192 rows) each cell otherwise walks the whole list. Their reactions are
// warp sums with one atomicAdd per component into sforce. The block
// rectangle is chosen by the wrapper (kernel2.newton_launch_plan) for at
// least 2 x 132 blocks where the grid has that many cells.
//
// What bounds it now: instruction issue and latency in the candidate walk
// (2 blocks of 16 warps an SM). At the 2^20 spec one call tests 53760
// cells x ~13.5 x 19.5 = 1.4e7 candidates against the home boxes,
// lane-parallel, then walks about half of them in warp iterations of ~15
// instructions (LDS, d, r2 rounded without FMA, the test, a vote), and in
// about half of those the radial, the forward sums and the reaction; the
// idle lanes past a cell's count (39 % of 32 at a mean of 19.5) are the
// main waste left.
//
// Rounding: r2 = (dx*dx + dy*dy) + dz*dz and the radial are written with
// __fmul_rn/__fadd_rn/__fdiv_rn so nvcc cannot contract them into FMAs:
// the unshifted LJ force jumps by 0.039 at the cutoff, so an r2 rounded
// otherwise than in the plain version could move a pair across it. The
// reactions are summed in another order than the plain version's, and the
// block flush adds with float atomics, so the last bits of the outputs
// change from run to run.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxWarps = 16;  // one warp per home cell of a block
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kLayers = 2;                // dz = 0, 1
constexpr float kEmptyX = 5.0e8f;         // a slot is empty iff x >= kEmptyX
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;       // 227 KB, the opt-in limit of sm_90

struct Geom {
  int nx, nyb, nz, F, cap, nlane;
  float Lx, Ly, Lz;
  int cc, fc;    // the block's cells along x and along the fold
  int occ_trim;  // 0; 1 stops every candidate loop one row short (a control)
};

struct Radial {
  float c1, c2, rc2, lo;
};

// staged columns of a block: its cc x fc cells with a one-cell halo,
// column = cxr * (fc + 2) + fyr
__host__ __device__ inline int window(int cc, int fc) { return (cc + 2) * (fc + 2); }

// dynamic shared memory: float4 pos[2][cap][R], float react[3][2][cap][R]
// (rows R = W | 1 apart: an odd stride keeps the lanes' reads of one
// column on distinct banks), float4 shift[2][W], int base[2][W],
// occ[2][W], float strag[4][S], int reach[S], int box[8] (the home box's
// bounds and the count of reach)
size_t smem_bytes(int cap, int cc, int fc, int S) {
  const size_t w = window(cc, fc);
  return kLayers * ((16 + 12) * static_cast<size_t>(cap) * (w | 1) + (16 + 2 * 4) * w) +
         20 * static_cast<size_t>(S) + 32;
}

// float <-> int keeping the order of non-NaN floats, for int min/max
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// g(r2) = r2 < rc2 ? t^4 (c1 t^3 + c2) : 0 with t = 1 / max(r2, lo).
template <bool kApprox>
__device__ __forceinline__ float radial(float r2, const Radial& g) {
  const float r2c = fmaxf(r2, g.lo);
  float t;
  if (kApprox) {
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(r2c));
  } else {
    t = __fdiv_rn(1.0f, r2c);
  }
  const float t2 = __fmul_rn(t, t);
  const float t3 = __fmul_rn(t2, t);
  const float t4 = __fmul_rn(t2, t2);
  return r2 < g.rc2 ? __fmul_rn(t4, __fadd_rn(__fmul_rn(g.c1, t3), g.c2)) : 0.0f;
}

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
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

// The warp totals of x, y and z: lane 0 returns sum(x), lane 8 sum(y),
// lane 16 sum(z) (lane 24 returns 0). The first two rounds trade halves of
// the three values between partner lanes, so five shuffles sum all three.
__device__ __forceinline__ float warp_sum3(float x, float y, float z, int lane) {
  const bool hi = lane & 16;
  float k0 = hi ? z : x, k1 = hi ? 0.0f : y;
  const float s0 = hi ? x : z, s1 = hi ? y : 0.0f;
  k0 += __shfl_xor_sync(kFull, s0, 16);
  k1 += __shfl_xor_sync(kFull, s1, 16);
  const bool mid = lane & 8;
  float k = mid ? k1 : k0;
  k += __shfl_xor_sync(kFull, mid ? k0 : k1, 8);
  k += __shfl_xor_sync(kFull, k, 4);
  k += __shfl_xor_sync(kFull, k, 2);
  k += __shfl_xor_sync(kFull, k, 1);
  return k;
}

// Minus the warp total of (tx, ty, tz) into dst[0], dst[stride],
// dst[2 stride] (shared or global), one lane per component.
__device__ __forceinline__ void add_reaction(float* dst, int stride, float tx, float ty,
                                             float tz, int lane) {
  const float s = warp_sum3(tx, ty, tz, lane);
  if ((lane & 7) == 0 && lane < 24) atomicAdd(dst + (lane >> 3) * stride, -s);
}

// One candidate slot against every lane's home slot. `in`: this lane's
// pair lies inside the cutoff (warp-uniform slot, ballot taken here). The
// forward term goes into (ax, ay, az); minus its warp total, the reaction,
// into lane `slot` of (rx, ry, rz) when slot < 32 (one shuffle per
// component when a single lane is inside, else a warp sum), or straight
// into the shared tile at rdst for the rows past 32.
template <bool kApprox>
__device__ __forceinline__ void newton_term(bool in, float r2, float dxv, float dyv, float dzv,
                                            const Radial& rad, int slot, int lane, float* rdst,
                                            int span, float& ax, float& ay, float& az,
                                            float& rx, float& ry, float& rz) {
  const unsigned b = __ballot_sync(kFull, in);
  if (!b) return;
  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
  if (in) {
    const float gr = radial<kApprox>(r2, rad);
    tx = __fmul_rn(gr, dxv);
    ty = __fmul_rn(gr, dyv);
    tz = __fmul_rn(gr, dzv);
    ax += tx;
    ay += ty;
    az += tz;
  }
  if (slot >= 32) {
    add_reaction(rdst, span, tx, ty, tz, lane);
    return;
  }
  float sx, sy, sz;
  if (__popc(b) == 1) {
    const int src = __ffs(b) - 1;
    sx = __shfl_sync(kFull, tx, src);
    sy = __shfl_sync(kFull, ty, src);
    sz = __shfl_sync(kFull, tz, src);
  } else {
    const float s = warp_sum3(tx, ty, tz, lane);
    sx = __shfl_sync(kFull, s, 0);
    sy = __shfl_sync(kFull, s, 8);
    sz = __shfl_sync(kFull, s, 16);
  }
  if (lane == slot) {
    rx -= sx;
    ry -= sy;
    rz -= sz;
  }
}

// A lane's reaction sums (its candidate row) into the shared tile at r.
__device__ __forceinline__ void flush_lane(float* r, int span, float rx, float ry, float rz) {
  if (rx != 0.0f || ry != 0.0f || rz != 0.0f) {
    atomicAdd(r, rx);
    atomicAdd(r + span, ry);
    atomicAdd(r + 2 * span, rz);
  }
}

// kHalo: the z-slab mode of parallel/domain2.py (kernel2.py:74-84,
// halo_z=True). z is not periodic: the top home row's dz = +1 candidates are
// the ghost row gx, gy, gz ([1, nyb, CAP, NLANE], the up neighbour's first
// home row with z already image-shifted by the caller), and no Lz shift is
// applied. The reactions onto the ghost row land in the (1, dyb) groups at
// z = nz - 1, which the caller sends up before the fold.
template <bool kApprox, bool kHalo>
__global__ void __launch_bounds__(kMaxThreads, 2) newton_pair_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ gz,
    const float* __restrict__ strag,
    float* __restrict__ out, float* __restrict__ sforce, Geom g, Radial rad,
    int S, int self_half, int cellcenter) {
  extern __shared__ float4 smem4[];
  const int W = window(g.cc, g.fc);
  const int R = W | 1;  // the row stride of pos and react
  const int fw = g.fc + 2;
  const int span = kLayers * g.cap * R;                     // one staged grid
  float4* pos = smem4;                                      // [2][cap][R]
  float4* shift = pos + span;                               // [2][W]
  float* react = reinterpret_cast<float*>(shift + kLayers * W);  // [3][2][cap][R]
  int* base = reinterpret_cast<int*>(react + 3 * span);    // [2][W]
  int* occ = base + kLayers * W;                            // [2][W]
  float* sstrag = reinterpret_cast<float*>(occ + kLayers * W);  // [4][S]
  int* reach = reinterpret_cast<int*>(sstrag + 4 * S);     // [S]
  int* box = reach + S;  // ordered min x y z, max x y z, count of reach

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ncx = (g.nx + g.cc - 1) / g.cc;
  const int cx0 = (blockIdx.x % ncx) * g.cc;
  const int f0 = (blockIdx.x / ncx) * g.fc;
  const int yb = blockIdx.y;
  const int zc = blockIdx.z;
  const int ny = g.nyb * g.F;
  const int plane = g.cap * g.nlane;
  // layer 1 of the top row comes from the ghost row in the halo mode
  const bool ghost = kHalo && zc == g.nz - 1;

  // 1. where each staged column comes from and its image shift; the
  // reaction tile zeroed; the stragglers
  for (int lc = tid; lc < kLayers * W; lc += blockDim.x) {
    const int layer = lc / W;
    const int col = lc - layer * W;
    const int cxr = col / fw;
    const int cx = cx0 - 1 + cxr;
    const int cy = yb * g.F + f0 - 1 + (col - cxr * fw);
    int sz = zc + layer;
    float shz = 0.0f;
    if (sz >= g.nz) {
      if (kHalo) {
        sz = 0;  // row 0 of the ghost arrays
      } else {
        sz -= g.nz;
        shz = g.Lz;
      }
    }
    shift[lc] = make_float4(image(cx, g.nx, g.Lx), image(cy, ny, g.Ly), shz, 0.0f);
    const int wy = wrap(cy, ny);
    const int syb = wy / g.F;
    base[lc] = (sz * g.nyb + syb) * plane + wrap(cx, g.nx) * g.F + (wy - syb * g.F);
  }
  for (int e = tid; e < 3 * span; e += blockDim.x) react[e] = 0.0f;
  for (int e = tid; e < 4 * S; e += blockDim.x) sstrag[e] = strag[e];
  if (tid < 6) box[tid] = ordered(tid < 3 ? __int_as_float(0x7f800000) : -__int_as_float(0x7f800000));
  __syncthreads();

  // 2. stage every column's CAP slots, x y z into one float4 each
  for (int lr = warp; lr < kLayers * g.cap; lr += nwarps) {
    const int layer = lr / g.cap;
    const int row = lr - layer * g.cap;
    const bool from_ghost = ghost && layer == 1;
    const float* sx = from_ghost ? gx : x;
    const float* sy = from_ghost ? gy : y;
    const float* sz = from_ghost ? gz : z;
    for (int col = lane; col < W; col += 32) {
      const int src = base[layer * W + col] + row * g.nlane;
      float* dst = reinterpret_cast<float*>(pos + lr * R + col);
      cp_async4(dst, sx + src);
      cp_async4(dst + 1, sy + src);
      cp_async4(dst + 2, sz + src);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. per column (one warp each): occupancy, and the image shift added;
  // the bounding box of the block's home particles
  for (int lc = warp; lc < kLayers * W; lc += nwarps) {
    const float4 sh = shift[lc];
    const bool shifted = sh.x != 0.0f || sh.y != 0.0f || sh.z != 0.0f;
    const int layer = lc / W;
    const int col = lc - layer * W;
    const int cxr = col / fw, fyr = col - cxr * fw;
    const bool home_col = layer == 0 && cxr >= 1 && cxr <= g.cc && fyr >= 1 && fyr <= g.fc &&
                          cx0 - 1 + cxr < g.nx && f0 - 1 + fyr < g.F;
    float4* colp = pos + layer * g.cap * R + col;
    int n = 0;
    int lo[3] = {0x7fffffff, 0x7fffffff, 0x7fffffff};
    int hi[3] = {-0x7fffffff - 1, -0x7fffffff - 1, -0x7fffffff - 1};
    for (int r0 = 0; r0 < g.cap; r0 += 32) {
      const int r = r0 + lane;
      bool here = false;
      if (r < g.cap) {
        float4 p = colp[r * R];
        here = !(p.x >= kEmptyX);
        if (home_col && here && isfinite(p.x) && isfinite(p.y) && isfinite(p.z)) {
          const int o[3] = {ordered(p.x), ordered(p.y), ordered(p.z)};
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            lo[a] = min(lo[a], o[a]);
            hi[a] = max(hi[a], o[a]);
          }
        }
        if (shifted) {
          p.x = __fadd_rn(p.x, sh.x);
          p.y = __fadd_rn(p.y, sh.y);
          p.z = __fadd_rn(p.z, sh.z);
          colp[r * R] = p;
        }
      }
      const unsigned m = __ballot_sync(kFull, here);
      if (m) n = r0 + 32 - __clz(m);
    }
    if (lane == 0) occ[lc] = n;
    if (home_col && S > 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = __reduce_min_sync(kFull, lo[a]);
        hi[a] = __reduce_max_sync(kFull, hi[a]);
      }
      if (lane < 3) {
        atomicMin(box + lane, lane == 0 ? lo[0] : (lane == 1 ? lo[1] : lo[2]));
        atomicMax(box + 3 + lane, lane == 0 ? hi[0] : (lane == 1 ? hi[1] : hi[2]));
      }
    }
  }
  __syncthreads();

  // 3b. the stragglers within reach of the home box (one warp): the periodic
  // distance from a straggler to the box bounds that from any of its images
  // to any home particle, and with 0.01 of margin a straggler left out has
  // every pair outside the cutoff
  if (warp == 0 && S > 0) {
    const float L[3] = {g.Lx, g.Ly, g.Lz};
    float mid[3], half[3];
    bool any = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float l = unordered(box[a]), u = unordered(box[3 + a]);
      any = any && l <= u;
      mid[a] = 0.5f * (l + u);
      half[a] = 0.5f * (u - l);
    }
    const float rcut = sqrtf(rad.rc2) + 1.0e-2f;
    int count = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      bool keep = false;
      if (any && s < S) {
        const float sval = sstrag[3 * S + s];
        keep = cellcenter ? sval != 0.0f : sval > 0.5f;
        float d2 = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float t = sstrag[a * S + s] - mid[a];
          t -= L[a] * rintf(t / L[a]);
          const float e = fmaxf(fabsf(t) - half[a], 0.0f);
          d2 += e * e;
        }
        keep = keep && d2 < rcut * rcut;  // a NaN straggler is never kept
      }
      const unsigned b = __ballot_sync(kFull, keep);
      if (keep) reach[count + __popc(b & ((1u << lane) - 1u))] = s;
      count += __popc(b);
    }
    if (lane == 0) box[6] = count;
  }
  __syncthreads();

  // 4. one warp per (home cell, pass of 32 slots)
  const int ncell = g.cc * g.fc;
  const int npass = (g.cap + 31) >> 5;
  const float nan = __int_as_float(0x7fc00000);
  const float cut = sqrtf(rad.rc2) + 1.0e-2f;  // the cull's reach, with a margin for rounding
  const float cut2 = cut * cut;
  for (int item = warp; item < ncell * npass; item += nwarps) {
    const int pass = item / ncell;
    const int cell = item - pass * ncell;
    const int cxl = cell / g.fc;
    const int fl = cell - cxl * g.fc;
    const int cx = cx0 + cxl;
    const int f = f0 + fl;
    if (cx >= g.nx || f >= g.F) continue;
    const int hcol = (cxl + 1) * fw + fl + 1;
    const int nh = occ[hcol];  // layer 0 is dz = 0
    if ((pass << 5) >= nh) continue;
    const int c = (pass << 5) + lane;
    const bool active = c < nh;
    float4 h = make_float4(nan, nan, nan, 0.0f);
    if (active) h = pos[c * R + hcol];
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    // the box of this pass's home particles, for culling the candidates
    const bool fin = active && isfinite(h.x) && isfinite(h.y) && isfinite(h.z);
    const float inf = __int_as_float(0x7f800000);
    const float b0x = unordered(__reduce_min_sync(kFull, ordered(fin ? h.x : inf)));
    const float b0y = unordered(__reduce_min_sync(kFull, ordered(fin ? h.y : inf)));
    const float b0z = unordered(__reduce_min_sync(kFull, ordered(fin ? h.z : inf)));
    const float b1x = unordered(__reduce_max_sync(kFull, ordered(fin ? h.x : -inf)));
    const float b1y = unordered(__reduce_max_sync(kFull, ordered(fin ? h.y : -inf)));
    const float b1z = unordered(__reduce_max_sync(kFull, ordered(fin ? h.z : -inf)));

    // the home cell
    {
      const float4* q = pos + hcol;
      const int n = nh - g.occ_trim;
      if (self_half) {
        // the reaction on this pass's rows, in lane row - 32 pass
        float hx = 0.0f, hy = 0.0f, hz = 0.0f;
        for (int j = (pass << 5) + 1; j < n; ++j) {
          const float4 p = q[j * R];
          const float dxv = p.x - h.x, dyv = p.y - h.y, dzv = p.z - h.z;
          const float r2 = dist2(dxv, dyv, dzv);
          newton_term<kApprox>(c < j && r2 < rad.rc2 && r2 != 0.0f, r2, dxv, dyv, dzv, rad,
                               j - (pass << 5), lane, react + j * R + hcol, span, ax, ay, az,
                               hx, hy, hz);
        }
        flush_lane(react + ((pass << 5) + lane) * R + hcol, span, hx, hy, hz);
      } else {
        for (int j = 0; j < n; ++j) {  // every ordered pair, forward only
          const float4 p = q[j * R];
          const float dxv = p.x - h.x, dyv = p.y - h.y, dzv = p.z - h.z;
          const float r2 = dist2(dxv, dyv, dzv);
          if (r2 < rad.rc2 && r2 != 0.0f) {
            const float gr = radial<kApprox>(r2, rad);
            ax += __fmul_rn(gr, dxv);
            ay += __fmul_rn(gr, dyv);
            az += __fmul_rn(gr, dzv);
          }
        }
      }
    }
    // the 13 positive offsets: (0, 0, 1), (0, 1, -1..1), (1, -1..1, -1..1)
    for (int k = 0; k < 13; ++k) {
      int layer, col;
      if (k == 0) {
        layer = 0;
        col = (cxl + 2) * fw + fl + 1;
      } else if (k < 4) {
        layer = 0;
        col = (cxl + k - 1) * fw + fl + 2;
      } else {
        layer = 1;
        const int o = k - 4;  // dy = o / 3 - 1, dx = o % 3 - 1
        col = (cxl + o % 3) * fw + fl + o / 3;
      }
      const int n = occ[layer * W + col] - g.occ_trim;
      const int off = layer * g.cap * R + col;
      const float4* q = pos + off;
      float rx = 0.0f, ry = 0.0f, rz = 0.0f;  // the reaction on candidate row `lane`
      for (int j0 = 0; j0 < n; j0 += 32) {
        // each lane tests one candidate against the home box: a candidate
        // farther than the cutoff and a margin from the box has every pair
        // outside it
        bool keep = false;
        if (j0 + lane < n) {
          const float4 p = q[(j0 + lane) * R];
          const float ex = fmaxf(fmaxf(b0x - p.x, p.x - b1x), 0.0f);
          const float ey = fmaxf(fmaxf(b0y - p.y, p.y - b1y), 0.0f);
          const float ez = fmaxf(fmaxf(b0z - p.z, p.z - b1z), 0.0f);
          keep = ex * ex + ey * ey + ez * ez < cut2;
        }
        unsigned b = __ballot_sync(kFull, keep);
        while (b) {  // the survivors, one per vote
          const int ja = j0 + __ffs(b) - 1;
          b &= b - 1;
          const float4 pa = q[ja * R];
          const float dax = pa.x - h.x, day = pa.y - h.y, daz = pa.z - h.z;
          const float r2a = dist2(dax, day, daz);
          newton_term<kApprox>(r2a < rad.rc2, r2a, dax, day, daz, rad, ja, lane,
                               react + off + ja * R, span, ax, ay, az, rx, ry, rz);
        }
      }
      flush_lane(react + off + lane * R, span, rx, ry, rz);
    }
    // the stragglers within reach of the block
    const int nreach = S > 0 ? box[6] : 0;
    if (nreach > 0) {
      float ccx = 0.0f, ccy = 0.0f, ccz = 0.0f;
      const float iLx = 1.0f / g.Lx, iLy = 1.0f / g.Ly, iLz = 1.0f / g.Lz;
      if (cellcenter) {
        const float csx = g.Lx / g.nx, csy = g.Ly / ny, csz = g.Lz / g.nz;
        const int cy = yb * g.F + f;
        ccx = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(cx), 0.5f), csx), 0.5f * g.Lx);
        ccy = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(cy), 0.5f), csy), 0.5f * g.Ly);
        ccz = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(zc), 0.5f), csz), 0.5f * g.Lz);
      }
      for (int i = 0; i < nreach; ++i) {
        const int s = reach[i];
        const float sx = sstrag[s], sy = sstrag[S + s], sz = sstrag[2 * S + s];
        const float sval = sstrag[3 * S + s];
        float dxv, dyv, dzv;
        bool in;
        if (cellcenter) {
          dxv = __fsub_rn(sx, __fmul_rn(g.Lx, rintf(__fmul_rn(__fsub_rn(sx, ccx), iLx)))) - h.x;
          dyv = __fsub_rn(sy, __fmul_rn(g.Ly, rintf(__fmul_rn(__fsub_rn(sy, ccy), iLy)))) - h.y;
          dzv = __fsub_rn(sz, __fmul_rn(g.Lz, rintf(__fmul_rn(__fsub_rn(sz, ccz), iLz)))) - h.z;
          in = sval != 0.0f;  // g = radial * valid
        } else {
          dxv = sx - h.x;
          dyv = sy - h.y;
          dzv = sz - h.z;
          dxv = __fsub_rn(dxv, __fmul_rn(g.Lx, rintf(__fmul_rn(dxv, iLx))));
          dyv = __fsub_rn(dyv, __fmul_rn(g.Ly, rintf(__fmul_rn(dyv, iLy))));
          dzv = __fsub_rn(dzv, __fmul_rn(g.Lz, rintf(__fmul_rn(dzv, iLz))));
          in = sval > 0.5f && h.x < 1.0e8f;
        }
        const float r2 = dist2(dxv, dyv, dzv);
        in = in && active && r2 < rad.rc2;
        if (!__any_sync(kFull, in)) continue;
        float tx = 0.0f, ty = 0.0f, tz = 0.0f;
        if (in) {
          float gr = radial<kApprox>(r2, rad);
          if (cellcenter) gr = __fmul_rn(gr, sval);
          tx = __fmul_rn(gr, dxv);
          ty = __fmul_rn(gr, dyv);
          tz = __fmul_rn(gr, dzv);
          ax += tx;
          ay += ty;
          az += tz;
        }
        add_reaction(sforce + 3 * s, 1, tx, ty, tz, lane);
      }
    }
    // the home force, with the reactions onto this pass's home rows, beside
    // the other warps' reactions onto the same slots
    if (active) flush_lane(react + c * R + hcol, span, ax, ay, az);
  }
  __syncthreads();

  // 5. flush the block's tile: each nonzero slot to its output grid, at the
  // candidate's row and lane of the HOME block
  const size_t T = static_cast<size_t>(g.nz) * g.nyb * plane;
  const size_t blk = (static_cast<size_t>(zc) * g.nyb + yb) * plane;
  for (int e = tid; e < span; e += blockDim.x) {
    const float vx = react[e], vy = react[span + e], vz = react[2 * span + e];
    if (vx == 0.0f && vy == 0.0f && vz == 0.0f) continue;
    const int lr = e / R;
    const int col = e - lr * R;
    const int layer = lr / g.cap;
    const int row = lr - layer * g.cap;
    const int cxr = col / fw;
    const int t = f0 - 1 + (col - cxr * fw);  // fold index from the home y-block's start
    const int dyb = t < 0 ? -1 : (t >= g.F ? 1 : 0);
    // home, group (0, 1), or group (1, dyb) of REACTION_GROUPS
    const int grid = layer == 0 ? (dyb == 0 ? 0 : 12) : 3 + 3 * (dyb + 1);
    float* o = out + grid * T + blk + static_cast<size_t>(row) * g.nlane +
               wrap(cx0 - 1 + cxr, g.nx) * g.F + (t - dyb * g.F);
    atomicAdd(o, vx);
    atomicAdd(o + T, vy);
    atomicAdd(o + 2 * T, vz);
  }
}

template <bool kApprox, bool kHalo>
int set_smem(size_t smem) {
  static size_t enabled = 0;  // dynamic shared memory allowed so far
  if (smem <= enabled) return 0;
  cudaError_t e = cudaFuncSetAttribute(newton_pair_kernel<kApprox, kHalo>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(newton_pair_kernel<kApprox, kHalo>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  enabled = smem;
  return 0;
}

template <bool kHalo>
int launch(const float* x, const float* y, const float* z, const float* gx, const float* gy,
           const float* gz, const float* strag, float* out, float* sforce, const Geom& g,
           const Radial& rad, int S, int self_half, int cellcenter, int approx, void* stream) {
  const size_t smem = smem_bytes(g.cap, g.cc, g.fc, S);
  if (g.cc < 1 || g.fc < 1 || g.cc * g.fc > kMaxWarps || g.cc > g.nx || g.fc > g.F ||
      g.occ_trim < 0 || S < 0 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = approx ? set_smem<true, kHalo>(smem) : set_smem<false, kHalo>(smem);
  if (err) return err;
  const int ncx = (g.nx + g.cc - 1) / g.cc;
  const int ncf = (g.F + g.fc - 1) / g.fc;
  const dim3 grid(ncx * ncf, g.nyb, g.nz);
  const dim3 block(32 * g.cc * g.fc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (approx) {
    newton_pair_kernel<true, kHalo><<<grid, block, smem, st>>>(
        x, y, z, gx, gy, gz, strag, out, sforce, g, rad, S, self_half, cellcenter);
  } else {
    newton_pair_kernel<false, kHalo><<<grid, block, smem, st>>>(
        x, y, z, gx, gy, gz, strag, out, sforce, g, rad, S, self_half, cellcenter);
  }
  return static_cast<int>(cudaGetLastError());
}

const float* cf(void* p) { return static_cast<const float*>(p); }

}  // namespace

// strag: float32 [4, S] (x, y, z, valid) or null when S == 0. cc, fc: the
// block's cells along x and the fold (kernel2.newton_launch_plan); occ_trim:
// 0 (1 only for the check's control).
extern "C" int uammd_newton_pair(void* x, void* y, void* z, void* strag, void* out,
                                 void* sforce, int nx, int nyb, int nz, int F,
                                 int cap, int S, int self_half, int cellcenter,
                                 int approx, float Lx, float Ly, float Lz,
                                 float c1, float c2, float rc2, float lo,
                                 int cc, int fc, int occ_trim, void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, cc, fc, occ_trim};
  return launch<false>(cf(x), cf(y), cf(z), nullptr, nullptr, nullptr, cf(strag),
                       static_cast<float*>(out), static_cast<float*>(sforce), g,
                       Radial{c1, c2, rc2, lo}, S, self_half, cellcenter, approx, stream);
}

// The halo mode: gx, gy, gz float32 [1, nyb, CAP, NLANE], the ghost row.
// The stragglers are min-imaged per pair (cell centres are not global here).
extern "C" int uammd_newton_pair_halo(void* x, void* y, void* z, void* gx, void* gy, void* gz,
                                      void* strag, void* out, void* sforce, int nx, int nyb,
                                      int nz, int F, int cap, int S, int self_half, int approx,
                                      float Lx, float Ly, float Lz, float c1, float c2,
                                      float rc2, float lo, int cc, int fc, int occ_trim,
                                      void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, cc, fc, occ_trim};
  return launch<true>(cf(x), cf(y), cf(z), cf(gx), cf(gy), cf(gz), cf(strag),
                      static_cast<float*>(out), static_cast<float*>(sforce), g,
                      Radial{c1, c2, rc2, lo}, S, self_half, 0, approx, stream);
}

// The dynamic shared memory of one block, for the wrapper's plan to check.
extern "C" long long uammd_newton_pair_smem(int cap, int cc, int fc, int S) {
  return static_cast<long long>(smem_bytes(cap, cc, fc, S));
}

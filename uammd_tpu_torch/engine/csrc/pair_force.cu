// Short-range LJ pair force on the grid-resident layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/pair_kernel.py:
// make_pair_force_kernel (:81, pallas_call at :272), in three modes, each
// force-only mode with either of two radials.
//
// Force only (:192-205, entry uammd_pair_force): for every home slot
// (z, yb, c, lane) it sums g(r2) * d over the slots of the 27 neighbour
// cells (home cell and self slot included), with d = r_j - r_i after the
// periodic image shift, r2s = max(r2, clamp_lo) and
// g = r2 < rc2 ? lj_g(r2s) : 0. Self and empty candidates contribute
// exactly 0 (d = 0, or r2 ~ 1e18 fails the cutoff), so the candidate loop
// stops at each cell's occupancy. A NaN coordinate reaches every slot of
// the 27 cells around it through 0 * NaN, as in the TPU kernel's select.
//
// Observables (:206-231, entry uammd_pair_force_obs): the force, the
// per-particle energy (half of lj_e(r2) per pair, e_shift subtracted), the
// virial (sum of -g r2 / 2) and the six stress components (xx, xy, xz, yy,
// yz, zz of -g d_a d_b / 2; trace = virial). This mode drops the clamp and
// masks with inside = r2 < rc2 && r2 > 1e-10: the radial is evaluated only
// inside; a non-finite r2 adds the plain version's 0 * d to the force and
// stress. Eleven sums per home slot, in registers.
//
// Halo (:99-102, :142-146, entry uammd_pair_force_halo): the force-only mode
// on a z-slab of parallel/domain.py, extended by one ghost row at each end
// whose z the caller has image-shifted. The z index still wraps, but no Lz
// shift is applied; the ghost rows' own outputs are garbage the caller drops.
//
// Radials: md.lj_g (entries above), or the fused LJ radial md.lj_g_fused
// (md.LJFused; entries uammd_pair_force_fused and _fused_halo, as
// parallel/pse_dd.py:173-177 runs it): the kernel's own cutoff and clamp
// around it, g = r2 < rc2 ? fused(max(r2, clamp_lo)) : 0 with
// fused(r) = r < frc2 ? t^4 (c1 t^3 + c2) : 0, t = 1 / max(r, flo), rounded
// as the plain version rounds it; approx takes rcp.approx.ftz.f32 for the
// division, as the Newton pair kernel does.
//
// Layout: arrays are [nz, nyb, CAP, NLANE] float32; lane l = cx*F + f is
// cell (cx, y = yb*F + f). A slot is empty iff x >= 5e8 (EMPTY_POS is 1e9;
// a NaN x counts as occupied). Occupancy is read from the positions: a
// cell's count is its last occupied row + 1 (holes below it are evaluated
// and contribute 0), so no state field is needed.
//
// Why this design: with one thread per home slot and the 128 lanes of a warp
// in 128 different cells, every candidate loop runs over all CAP rows:
// 27 * CAP = 1080 slot evaluations per home slot, empty home slots
// included, 4.2x the real ordered pairs at the 2^20 spec
// ([42, 10, 40, 128], mean occupancy 19.5), and blocks of a few home rows
// stage each (z, yb) column's candidates again and again.
//
// Design: one warp per cell, one lane per home slot of that cell. All lanes
// of a warp share each candidate cell, so the candidate slot j is a shared
// memory broadcast (one LDS.128 of x, y, z) and the trip count is that
// cell's occupancy, the same for the whole warp: no padding on the
// candidate side. Lanes past the home count compute the empty slots'
// (0 or NaN) sums in the same instructions; a cell with more than 32 slots
// takes a second pass of its warp; the home slots past the last pass get
// 0, or NaN where a non-finite coordinate lies within the 27 cells. In the
// force-only modes each lane first tests one candidate (32 at a time)
// against the bounding box of the warp's home particles, and the warp
// walks only the candidates within the cutoff and a 0.01 margin of it (by
// the cell geometry about half of them at the 2^20 spec); a column with a
// non-finite coordinate, or a warp with a non-finite home particle, is
// walked whole, so that NaN lands where the plain version puts it.
// A block is (z, yb, a rectangle of cc x fc cells along x and the fold),
// one warp per cell (at most 16), and it stages its rectangle with a
// one-cell halo, (cc + 2) x (fc + 2) columns of CAP slots, for the three z
// layers, once, with cp.async (4-byte copies into interleaved float4
// slots, since a column is strided in memory and NLANE need not be a
// multiple of 4; rows an odd number of slots apart, so that the lanes'
// reads down a column fall on distinct banks). The periodic image shift is
// added to the staged copy of every wrapped column (x + shift rounded as
// the plain version rounds it), so the inner loop has none. Not
// double-buffered inside a block: every warp's cell needs all 27 of the
// staged cells, and the 2 blocks of 16 warps that fit on an SM (73 KB each
// at the 2^20 spec) overlap one block's copies with the other's
// arithmetic, without carrying a warp's sums across a block barrier per
// tile. The block rectangle is chosen by the wrapper
// (pair_kernel.pair_launch_plan) for at least 2 x 132 blocks where the grid
// has that many cells. Dynamic shared memory above 48 KB is enabled with
// cudaFuncSetAttribute.
//
// What bounds it now: instruction issue and latency in the candidate walk.
// At the 2^20 spec one call tests 53760 cells x 27 x ~19.5 candidates
// against the home boxes, lane-parallel, and walks about half of them in
// warp iterations of ~17 instructions (LDS, d, r2 rounded without FMA, the
// cutoff test, 3 FMA), plus the radial (an IEEE division and 8
// multiply/adds) in the iterations where some lane is inside the cutoff;
// the idle lanes past a cell's count (39 % of 32 at a mean of 19.5) are the
// main waste left. The observable mode walks every candidate.
//
// Rounding: r2 = (dx*dx + dy*dy) + dz*dz with __fmul_rn/__fadd_rn (the
// unshifted LJ force jumps by 0.039 at rc, so an r2 rounded otherwise than
// in the plain version could move a pair across the cutoff), the shifted
// candidate x + shift rounded once, and the IEEE division inside the cutoff.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kMaxWarps = 16;  // one warp per home cell of a block
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kLayers = 3;                // dz = -1, 0, 1
constexpr float kEmptyX = 5.0e8f;         // a slot is empty iff x >= kEmptyX
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;       // 227 KB, the opt-in limit of sm_90

struct Geom {
  int nx, nyb, nz, F, cap, nlane;
  float Lx, Ly, Lz;
  int periodic_z;  // 0: z-slab halo mode, the z index wraps but takes no Lz shift
  int cc, fc;      // the block's cells along x and along the fold
  int occ_trim;    // 0; 1 stops every candidate loop one row short (a control)
};

// staged columns of a block: its cc x fc cells with a one-cell halo,
// column = cxr * (fc + 2) + fyr
__host__ __device__ inline int window(int cc, int fc) { return (cc + 2) * (fc + 2); }

// dynamic shared memory: float4 pos[3][cap][R] (rows R = W | 1 apart: an
// odd stride keeps the lanes' reads of one column on distinct banks),
// float4 shift[3][W], int base[3][W], occ[3][W], bad[3][W]
size_t smem_bytes(int cap, int cc, int fc) {
  const size_t w = window(cc, fc);
  return kLayers * (16 * static_cast<size_t>(cap) * (w | 1) + (16 + 3 * 4) * w);
}

// float <-> int keeping the order of non-NaN floats, for int min/max
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

struct Sums {
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  float en = 0.0f, vir = 0.0f, st[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
};

struct Lj {
  float rc2, clamp_lo, neg24eps, s2, c4eps, e_shift;
  float c1, c2, frc2, flo;  // the fused radial's (RAD kFused*)
};

// the radial of the force-only modes
constexpr int kLjG = 0;          // md.lj_g
constexpr int kFused = 1;        // md.lj_g_fused, IEEE division
constexpr int kFusedApprox = 2;  // md.lj_g_fused, rcp.approx.ftz.f32

// (dE/dr)/r of 12-6 LJ, written with one reciprocal as
// uammd_tpu/engine/md.py:lj_g. neg24eps = -24*epsilon, s2 = sigma^2.
__device__ __forceinline__ float lj_g(float r2, float neg24eps, float s2) {
  const float t = 1.0f / r2;
  const float inv2 = s2 * t;
  const float inv6 = inv2 * inv2 * inv2;
  return neg24eps * t * (2.0f * inv6 * inv6 - inv6);
}

// 12-6 LJ pair energy as uammd_tpu/engine/md.py:lj_e: c4eps = 4 epsilon,
// inv6 = (s2 / r2)^3, minus e_shift (0 unless shifted at shift_rc).
__device__ __forceinline__ float lj_e(float r2, float c4eps, float s2, float e_shift) {
  const float q = s2 / r2;
  const float inv6 = q * q * q;
  return c4eps * (inv6 * inv6 - inv6) - e_shift;
}

// md.lj_g_fused at r (already clamped at the kernel's clamp_lo).
template <bool APPROX>
__device__ __forceinline__ float lj_fused(float r, const Lj& lj) {
  const float rc = fmaxf(r, lj.flo);
  float t;
  if (APPROX) {
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(rc));
  } else {
    t = __fdiv_rn(1.0f, rc);
  }
  const float t2 = __fmul_rn(t, t);
  const float t3 = __fmul_rn(t2, t);
  const float t4 = __fmul_rn(t2, t2);
  return r < lj.frc2 ? __fmul_rn(t4, __fadd_rn(__fmul_rn(lj.c1, t3), lj.c2)) : 0.0f;
}

template <int RAD>
__device__ __forceinline__ float radial(float r2c, const Lj& lj) {
  if (RAD == kLjG) return lj_g(r2c, lj.neg24eps, lj.s2);
  return lj_fused<RAD == kFusedApprox>(r2c, lj);
}

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// The terms of candidate p on home slot h, into a.
template <bool OBS, int RAD>
__device__ __forceinline__ void pair_terms(const float4& p, const float4& h, Sums& a,
                                           const Lj& lj) {
  const float dxv = p.x - h.x;
  const float dyv = p.y - h.y;
  const float dzv = p.z - h.z;
  const float r2 = dist2(dxv, dyv, dzv);
  if (OBS) {
    if (r2 < lj.rc2 && r2 > 1e-10f) {
      const float gr = lj_g(r2, lj.neg24eps, lj.s2);
      a.ax += gr * dxv;
      a.ay += gr * dyv;
      a.az += gr * dzv;
      a.en += lj_e(r2, lj.c4eps, lj.s2, lj.e_shift);
      const float hg = -0.5f * gr;
      a.vir += hg * r2;
      a.st[0] += hg * dxv * dxv;
      a.st[1] += hg * dxv * dyv;
      a.st[2] += hg * dxv * dzv;
      a.st[3] += hg * dyv * dyv;
      a.st[4] += hg * dyv * dzv;
      a.st[5] += hg * dzv * dzv;
    } else if (!(r2 <= FLT_MAX)) {
      // the plain version's g = 0 times a non-finite d
      const float zg = 0.0f, hz = -0.0f;
      a.ax += zg * dxv;
      a.ay += zg * dyv;
      a.az += zg * dzv;
      a.st[0] += hz * dxv * dxv;
      a.st[1] += hz * dxv * dyv;
      a.st[2] += hz * dxv * dzv;
      a.st[3] += hz * dyv * dyv;
      a.st[4] += hz * dyv * dzv;
      a.st[5] += hz * dzv * dzv;
    }
    return;
  }
  // Branch around the division only: a NaN r2 still reaches the sums
  // through 0 * NaN, as in the TPU kernel's select.
  float gr = 0.0f;
  if (r2 < lj.rc2) gr = radial<RAD>(fmaxf(r2, lj.clamp_lo), lj);
  a.ax += gr * dxv;
  a.ay += gr * dyv;
  a.az += gr * dzv;
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

// OBS: obs holds the 8 grids energy, virial, stress x 6, each
// T = nz * nyb * CAP * NLANE floats apart.
template <bool OBS, int RAD>
__global__ void __launch_bounds__(kMaxThreads, 2) pair_force_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ z,
    float* __restrict__ fx, float* __restrict__ fy, float* __restrict__ fz,
    float* __restrict__ obs, Geom g, Lj lj) {
  extern __shared__ float4 smem4[];
  const int W = window(g.cc, g.fc);
  const int R = W | 1;  // the row stride of pos
  const int fw = g.fc + 2;
  float4* pos = smem4;                                  // [3][cap][R]
  float4* shift = pos + kLayers * g.cap * R;            // [3][W]
  int* base = reinterpret_cast<int*>(shift + kLayers * W);  // [3][W]
  int* occ = base + kLayers * W;                        // [3][W]
  int* bad = occ + kLayers * W;                         // [3][W]

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
  const int plane = g.cap * g.nlane;  // one [CAP, NLANE] block

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
  __syncthreads();

  // 2. stage every column's CAP slots, x y z into one float4 each
  for (int lr = warp; lr < kLayers * g.cap; lr += nwarps) {
    const int layer = lr / g.cap;
    const int row = lr - layer * g.cap;
    for (int col = lane; col < W; col += 32) {
      const int src = base[layer * W + col] + row * g.nlane;
      float* dst = reinterpret_cast<float*>(pos + lr * R + col);
      cp_async4(dst, x + src);
      cp_async4(dst + 1, y + src);
      cp_async4(dst + 2, z + src);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. per column (one warp each): occupancy, the non-finite coordinates
  // (bits x, y, z) among its occupied slots, and the image shift added
  for (int lc = warp; lc < kLayers * W; lc += nwarps) {
    const float4 sh = shift[lc];
    const bool shifted = sh.x != 0.0f || sh.y != 0.0f || sh.z != 0.0f;
    const int layer = lc / W;
    float4* colp = pos + layer * g.cap * R + (lc - layer * W);
    int n = 0;
    unsigned nonfinite = 0;
    for (int r0 = 0; r0 < g.cap; r0 += 32) {
      const int r = r0 + lane;
      bool here = false;
      bool bx = false, by = false, bz = false;
      if (r < g.cap) {
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
      }
      const unsigned m = __ballot_sync(kFull, here);
      if (m) n = r0 + 32 - __clz(m);
      nonfinite |= (__any_sync(kFull, bx) ? 1u : 0u) | (__any_sync(kFull, by) ? 2u : 0u) |
                   (__any_sync(kFull, bz) ? 4u : 0u);
    }
    if (lane == 0) {
      occ[lc] = n;
      bad[lc] = static_cast<int>(nonfinite);
    }
  }
  __syncthreads();

  // 4. one warp per (home cell, pass of 32 slots)
  const int ncell = g.cc * g.fc;
  const int npass = (g.cap + 31) >> 5;
  const size_t blk = (static_cast<size_t>(zc) * g.nyb + yb) * plane;
  const size_t T = static_cast<size_t>(g.nz) * g.nyb * plane;
  const float cut = sqrtf(lj.rc2) + 1.0e-2f;  // the cull's reach, with a margin for rounding
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
    const int np = (occ[W + hcol] + 31) >> 5;  // layer 1 is dz = 0
    const int last = np > 0 ? np - 1 : 0;
    if (pass > last) continue;
    const int c = (pass << 5) + lane;
    const size_t hlane = static_cast<size_t>(cx) * g.F + f;
    if (pass < np) {
      float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c < g.cap) h = pos[(g.cap + c) * R + hcol];
      Sums a;
      // The force-only modes cull the candidates of a column against the
      // box of the warp's occupied home slots: each lane tests one (32 at
      // a time), and the warp walks only those within the cutoff and a
      // 0.01 margin of the box. A candidate left out is finite and far from
      // every home slot, so its terms are g * d = 0 (empty slots' too);
      // a column with a non-finite coordinate, or a warp with a non-finite
      // home slot, is walked whole, so that a NaN reaches every slot the
      // plain version gives it.
      const bool here = c < g.cap && !(h.x >= kEmptyX);
      const bool fin = isfinite(h.x) && isfinite(h.y) && isfinite(h.z);
      const bool cull = !OBS && __all_sync(kFull, !here || fin);
      const float inf = __int_as_float(0x7f800000);
      const bool in_box = here && fin;
      const float b0x = unordered(__reduce_min_sync(kFull, ordered(in_box ? h.x : inf)));
      const float b0y = unordered(__reduce_min_sync(kFull, ordered(in_box ? h.y : inf)));
      const float b0z = unordered(__reduce_min_sync(kFull, ordered(in_box ? h.z : inf)));
      const float b1x = unordered(__reduce_max_sync(kFull, ordered(in_box ? h.x : -inf)));
      const float b1y = unordered(__reduce_max_sync(kFull, ordered(in_box ? h.y : -inf)));
      const float b1z = unordered(__reduce_max_sync(kFull, ordered(in_box ? h.z : -inf)));
      for (int layer = 0; layer < kLayers; ++layer) {
        for (int dyi = 0; dyi < 3; ++dyi) {
          for (int dxi = 0; dxi < 3; ++dxi) {
            const int col = (cxl + dxi) * fw + fl + dyi;
            const int n = occ[layer * W + col] - g.occ_trim;
            const float4* q = pos + layer * g.cap * R + col;
            if (cull && bad[layer * W + col] == 0) {
              for (int j0 = 0; j0 < n; j0 += 32) {
                bool keep = false;
                if (j0 + lane < n) {
                  const float4 p = q[(j0 + lane) * R];
                  const float ex = fmaxf(fmaxf(b0x - p.x, p.x - b1x), 0.0f);
                  const float ey = fmaxf(fmaxf(b0y - p.y, p.y - b1y), 0.0f);
                  const float ez = fmaxf(fmaxf(b0z - p.z, p.z - b1z), 0.0f);
                  keep = ex * ex + ey * ey + ez * ez < cut2;
                }
                unsigned b = __ballot_sync(kFull, keep);
                while (b) {
                  const int j = j0 + __ffs(b) - 1;
                  b &= b - 1;
                  pair_terms<OBS, RAD>(q[j * R], h, a, lj);  // the same slot for every lane
                }
              }
            } else {
#pragma unroll 4
              for (int j = 0; j < n; ++j) pair_terms<OBS, RAD>(q[j * R], h, a, lj);
            }
          }
        }
      }
      if (c < g.cap) {
        const size_t hidx = blk + static_cast<size_t>(c) * g.nlane + hlane;
        fx[hidx] = a.ax;
        fy[hidx] = a.ay;
        fz[hidx] = a.az;
        if (OBS) {
          obs[hidx] = 0.5f * a.en;
          obs[T + hidx] = a.vir;
#pragma unroll
          for (int k = 0; k < 6; ++k) obs[(2 + k) * T + hidx] = a.st[k];
        }
      }
    }
    if (pass == last && (np << 5) < g.cap) {
      // the empty slots past the passes: every term is 0 * d, which is NaN
      // only in the coordinates where some candidate is not finite
      unsigned nf = 0;
      for (int layer = 0; layer < kLayers; ++layer)
        for (int dyi = 0; dyi < 3; ++dyi)
          for (int dxi = 0; dxi < 3; ++dxi)
            nf |= static_cast<unsigned>(bad[layer * W + (cxl + dxi) * fw + fl + dyi]);
      const float nan = __int_as_float(0x7fc00000);
      for (int c2 = (np << 5) + lane; c2 < g.cap; c2 += 32) {
        const size_t hidx = blk + static_cast<size_t>(c2) * g.nlane + hlane;
        fx[hidx] = (nf & 1u) ? nan : 0.0f;
        fy[hidx] = (nf & 2u) ? nan : 0.0f;
        fz[hidx] = (nf & 4u) ? nan : 0.0f;
        if (OBS) {
          obs[hidx] = 0.0f;
          obs[T + hidx] = 0.0f;
          const unsigned pairs[6] = {1u, 3u, 5u, 2u, 6u, 4u};  // xx xy xz yy yz zz
#pragma unroll
          for (int k = 0; k < 6; ++k) obs[(2 + k) * T + hidx] = (nf & pairs[k]) ? nan : 0.0f;
        }
      }
    }
  }
}

template <bool OBS, int RAD = kLjG>
int launch(void* x, void* y, void* z, void* fx, void* fy, void* fz, void* obs, const Geom& g,
           const Lj& lj, void* stream) {
  const size_t smem = smem_bytes(g.cap, g.cc, g.fc);
  if (g.cc < 1 || g.fc < 1 || g.cc * g.fc > kMaxWarps || g.cc > g.nx || g.fc > g.F ||
      g.occ_trim < 0 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static size_t enabled = 0;  // dynamic shared memory allowed so far
  if (smem > enabled) {
    cudaError_t e = cudaFuncSetAttribute(pair_force_kernel<OBS, RAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(pair_force_kernel<OBS, RAD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    enabled = smem;
  }
  const int ncx = (g.nx + g.cc - 1) / g.cc;
  const int ncf = (g.F + g.fc - 1) / g.fc;
  const dim3 grid(ncx * ncf, g.nyb, g.nz);
  const dim3 block(32 * g.cc * g.fc);
  pair_force_kernel<OBS, RAD><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(z), static_cast<float*>(fx), static_cast<float*>(fy),
      static_cast<float*>(fz), static_cast<float*>(obs), g, lj);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cc, fc: the block's cells along x and the fold (pair_kernel.pair_launch_plan);
// occ_trim: 0 (1 only for the check's control).
extern "C" int uammd_pair_force(void* x, void* y, void* z, void* fx, void* fy,
                                void* fz, int nx, int nyb, int nz, int F,
                                int cap, float Lx, float Ly, float Lz,
                                float rc2, float clamp_lo, float neg24eps,
                                float s2, int cc, int fc, int occ_trim, void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, 1, cc, fc, occ_trim};
  const Lj lj{rc2, clamp_lo, neg24eps, s2, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  return launch<false>(x, y, z, fx, fy, fz, nullptr, g, lj, stream);
}

// The halo mode of parallel/domain.py (pair_kernel.py:89, periodic_z=False):
// x, y, z are a z-slab extended by one ghost row at each end, whose z the
// caller has image-shifted; the caller drops the ghost rows of the output.
extern "C" int uammd_pair_force_halo(void* x, void* y, void* z, void* fx, void* fy, void* fz,
                                     int nx, int nyb, int nz, int F, int cap, float Lx,
                                     float Ly, float Lz, float rc2, float clamp_lo,
                                     float neg24eps, float s2, int cc, int fc, int occ_trim,
                                     void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, 0, cc, fc, occ_trim};
  const Lj lj{rc2, clamp_lo, neg24eps, s2, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  return launch<false>(x, y, z, fx, fy, fz, nullptr, g, lj, stream);
}

namespace {

int fused_launch(void* x, void* y, void* z, void* fx, void* fy, void* fz, int nx, int nyb,
                 int nz, int F, int cap, float Lx, float Ly, float Lz, float rc2,
                 float clamp_lo, float c1, float c2, float frc2, float flo, int approx, int cc,
                 int fc, int occ_trim, void* stream, int periodic_z) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, periodic_z, cc, fc, occ_trim};
  const Lj lj{rc2, clamp_lo, 0.0f, 0.0f, 0.0f, 0.0f, c1, c2, frc2, flo};
  if (approx) return launch<false, kFusedApprox>(x, y, z, fx, fy, fz, nullptr, g, lj, stream);
  return launch<false, kFused>(x, y, z, fx, fy, fz, nullptr, g, lj, stream);
}

}  // namespace

// The force-only mode with the fused LJ radial (md.LJFused: c1, c2, its
// cutoff frc2 and clamp flo; approx 1 for the approximate reciprocal),
// inside the kernel's own cutoff rc2 and clamp_lo. rc2 is also the cull's
// reach, so the wrapper passes min(rc2, frc2): the radial is 0 beyond frc2.
extern "C" int uammd_pair_force_fused(void* x, void* y, void* z, void* fx, void* fy, void* fz,
                                      int nx, int nyb, int nz, int F, int cap, float Lx,
                                      float Ly, float Lz, float rc2, float clamp_lo, float c1,
                                      float c2, float frc2, float flo, int approx, int cc, int fc,
                                      int occ_trim, void* stream) {
  return fused_launch(x, y, z, fx, fy, fz, nx, nyb, nz, F, cap, Lx, Ly, Lz, rc2, clamp_lo, c1,
                      c2, frc2, flo, approx, cc, fc, occ_trim, stream, 1);
}

// The same in the halo mode (parallel/pse_dd.py:173-177).
extern "C" int uammd_pair_force_fused_halo(void* x, void* y, void* z, void* fx, void* fy,
                                           void* fz, int nx, int nyb, int nz, int F, int cap,
                                           float Lx, float Ly, float Lz, float rc2,
                                           float clamp_lo, float c1, float c2, float frc2,
                                           float flo, int approx, int cc, int fc, int occ_trim,
                                           void* stream) {
  return fused_launch(x, y, z, fx, fy, fz, nx, nyb, nz, F, cap, Lx, Ly, Lz, rc2, clamp_lo, c1,
                      c2, frc2, flo, approx, cc, fc, occ_trim, stream, 0);
}

// obs: float32 [8, T] (energy, virial, stress xx xy xz yy yz zz).
extern "C" int uammd_pair_force_obs(void* x, void* y, void* z, void* fx, void* fy, void* fz,
                                    void* obs, int nx, int nyb, int nz, int F, int cap, float Lx,
                                    float Ly, float Lz, float rc2, float neg24eps, float s2,
                                    float c4eps, float e_shift, int cc, int fc, int occ_trim,
                                    void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, 1, cc, fc, occ_trim};
  const Lj lj{rc2, 0.0f, neg24eps, s2, c4eps, e_shift, 0.0f, 0.0f, 0.0f, 0.0f};
  return launch<true>(x, y, z, fx, fy, fz, obs, g, lj, stream);
}

// The dynamic shared memory of one block, for the wrapper's plan to check.
extern "C" long long uammd_pair_force_smem(int cap, int cc, int fc) {
  return static_cast<long long>(smem_bytes(cap, cc, fc));
}

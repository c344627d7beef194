// Newton's-third-law LJ pair force with straggler rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/kernel2.py:make_newton_pair_kernel
// (pallas_call at :447), with the radial uammd_tpu/engine/md.py:lj_g_fused.
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
//
// Design: one thread per home slot, a block owning `rows` home rows of one
// (z, yb) across all NLANE lanes (blockDim = (NLANE, rows)). For dz = 0 and
// then dz = 1 it stages kJ candidate rows of the three y-blocks yb-1, yb,
// yb+1 of slab z+dz in shared memory (as pair_force.cu does), and every
// thread walks its offsets over the staged rows; neighbouring lanes read
// neighbouring shared addresses. Reactions go out with float atomicAdd,
// only for pairs inside the cutoff, so the atomics follow the
// ~33 neighbours per particle, not the padded candidate slots; their order
// changes from run to run, so the sums do too, in the last bits.
// self_half: the home cell's pairs are taken once (candidate row > home
// row) with the reaction added into home, instead of both directions.
// cellcenter: stragglers are min-imaged once against the home cell centre
// (kernel2.py:314-352) instead of per pair (:353-378).
// Halo mode (entry uammd_newton_pair_halo, kernel2.py:74-134 halo_z=True):
// the z-slab of parallel/domain2.py; the top home row stages its dz = +1
// rows from the caller's ghost row instead of row 0 + Lz. The same work per
// thread as the periodic kernel, which is instantiated apart (kHalo false).
//
// Rounding: r2 = (dx*dx + dy*dy) + dz*dz and the radial are written with
// __fmul_rn/__fadd_rn/__fdiv_rn so nvcc cannot contract them into FMAs:
// the unshifted LJ force jumps by 0.039 at the cutoff, so an r2 rounded
// otherwise than in the plain version could move a pair across it.
//
// What bounds it: arithmetic. Per home slot it evaluates (1 + 13) * CAP
// candidate slots of ~25 float32 instructions (CAP/2 for the self cell
// with self_half), half the 27 * CAP of pair_force.cu, plus the straggler
// list; it moves 3 input and 15 output grids.

#include <cuda_runtime.h>

namespace {

constexpr int kJ = 8;  // candidate rows staged per pass

struct Geom {
  int nx, nyb, nz, F, cap, nlane;
  float Lx, Ly, Lz;
};

struct Radial {
  float c1, c2, rc2, lo;
};

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

__device__ __forceinline__ int wrap_index(int s, int n, float L, float* shift) {
  if (s < 0) { *shift = -L; return s + n; }
  if (s >= n) { *shift = L; return s - n; }
  *shift = 0.0f;
  return s;
}

// kHalo: the z-slab mode of parallel/domain2.py (kernel2.py:74-84,
// halo_z=True). z is not periodic: the top home row's dz = +1 candidates are
// the ghost row gx, gy, gz ([1, nyb, CAP, NLANE], the up neighbour's first
// home row with z already image-shifted by the caller), and no Lz shift is
// applied. The reactions onto the ghost row land in the (1, dyb) groups at
// z = nz - 1, which the caller sends up before the fold.
template <bool kApprox, bool kHalo>
__global__ void newton_pair_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ gz,
    const float* __restrict__ strag,
    float* __restrict__ out, float* __restrict__ sforce, Geom g, Radial rad,
    int S, int self_half, int cellcenter) {
  extern __shared__ float smem[];  // [3 y-blocks][3 coords][kJ][nlane], [4][S]
  const int nlane = g.nlane;
  float* sstrag = smem + 9 * kJ * nlane;
  const int lane = threadIdx.x;
  const int c = blockIdx.x * blockDim.y + threadIdx.y;
  const int yb = blockIdx.y;
  const int zc = blockIdx.z;
  const bool home = c < g.cap;
  const int cx = lane / g.F;
  const int f = lane - cx * g.F;
  const int ny = g.nyb * g.F;
  const int cy = yb * g.F + f;
  const size_t plane = static_cast<size_t>(g.cap) * nlane;
  const size_t T = static_cast<size_t>(g.nz) * g.nyb * plane;
  const size_t blk = (static_cast<size_t>(zc) * g.nyb + yb) * plane;  // home block
  const size_t hidx = blk + static_cast<size_t>(c) * nlane + lane;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int coord_stride = kJ * nlane;

  for (int e = tid; e < 4 * S; e += nthreads) sstrag[e] = strag[e];

  float xi = 0.0f, yi = 0.0f, zi = 0.0f;
  if (home) {
    xi = x[hidx];
    yi = y[hidx];
    zi = z[hidx];
  }
  // An empty home slot (at EMPTY_POS = 1e9) has every real candidate far
  // outside the cutoff and an empty one at d = 0: all its terms are 0, so
  // its thread only helps to stage.
  const bool active = home && xi < 1.0e8f;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;

  for (int dz = 0; dz <= 1; ++dz) {
    float shz = 0.0f;
    int sz = zc + dz;
    const float* srcx = x;
    const float* srcy = y;
    const float* srcz = z;
    if (sz >= g.nz) {
      if constexpr (kHalo) {  // the ghost row, already shifted
        srcx = gx;
        srcy = gy;
        srcz = gz;
        sz = 0;
      } else {
        sz -= g.nz;
        shz = g.Lz;
      }
    }
    for (int j0 = 0; j0 < g.cap; j0 += kJ) {
      const int nj = min(kJ, g.cap - j0);
      const int per_block = nj * nlane;
      __syncthreads();  // previous pass done reading
      for (int e = tid; e < 3 * per_block; e += nthreads) {
        const int b = e / per_block;
        const int r = e - b * per_block;  // jj*nlane + l
        int syb = yb + b - 1;
        syb = syb < 0 ? syb + g.nyb : (syb >= g.nyb ? syb - g.nyb : syb);
        const size_t src =
            (static_cast<size_t>(sz) * g.nyb + syb) * plane + static_cast<size_t>(j0) * nlane + r;
        smem[(b * 3 + 0) * coord_stride + r] = srcx[src];
        smem[(b * 3 + 1) * coord_stride + r] = srcy[src];
        smem[(b * 3 + 2) * coord_stride + r] = srcz[src];
      }
      __syncthreads();
      if (!active) continue;

      if (dz == 0) {
        // the home cell (staged y-block 1, own lane)
        const float* sX = smem + 3 * coord_stride + lane;
        const float* sY = smem + 4 * coord_stride + lane;
        const float* sZ = smem + 5 * coord_stride + lane;
        for (int jj = 0; jj < nj; ++jj) {
          const int j = j0 + jj;
          if (self_half && j <= c) continue;
          const float dxv = sX[jj * nlane] - xi;
          const float dyv = sY[jj * nlane] - yi;
          const float dzv = sZ[jj * nlane] - zi;
          const float r2 = dist2(dxv, dyv, dzv);
          if (!(r2 < rad.rc2) || r2 == 0.0f) continue;  // g * d is 0 there
          const float gr = radial<kApprox>(r2, rad);
          const float tx = __fmul_rn(gr, dxv), ty = __fmul_rn(gr, dyv), tz = __fmul_rn(gr, dzv);
          ax += tx;
          ay += ty;
          az += tz;
          if (self_half) {
            const size_t d = blk + static_cast<size_t>(j) * nlane + lane;
            atomicAdd(out + d, -tx);
            atomicAdd(out + T + d, -ty);
            atomicAdd(out + 2 * T + d, -tz);
          }
        }
      }
      // positive offsets of this dz: (dz=1: dy in -1..1; dz=0: dy = 1, and
      // dy = 0 with dx = 1 only)
      for (int dy = (dz == 1 ? -1 : 0); dy <= 1; ++dy) {
        float shy;
        const int sy = wrap_index(cy + dy, ny, g.Ly, &shy);
        const int sf = sy % g.F;
        const int b = (f + dy < 0) ? 0 : ((f + dy >= g.F) ? 2 : 1);
        // the output grid of the reaction: home, or group (dz, b - 1)
        int target;
        if (dz == 0) {
          target = (b == 1) ? 0 : 3 + 3 * 3;  // home, or group (0, 1)
        } else {
          target = 3 + 3 * b;  // groups (1,-1), (1,0), (1,1)
        }
        float* o = out + static_cast<size_t>(target) * T;
        for (int dx = (dz == 0 && dy == 0 ? 1 : -1); dx <= 1; ++dx) {
          float shx;
          const int sx = wrap_index(cx + dx, g.nx, g.Lx, &shx);
          const int sl = sx * g.F + sf;
          const float* sX = smem + (b * 3 + 0) * coord_stride + sl;
          const float* sY = smem + (b * 3 + 1) * coord_stride + sl;
          const float* sZ = smem + (b * 3 + 2) * coord_stride + sl;
          for (int jj = 0; jj < nj; ++jj) {
            const float dxv = __fadd_rn(sX[jj * nlane], shx) - xi;
            const float dyv = __fadd_rn(sY[jj * nlane], shy) - yi;
            const float dzv = __fadd_rn(sZ[jj * nlane], shz) - zi;
            const float r2 = dist2(dxv, dyv, dzv);
            if (!(r2 < rad.rc2) || r2 == 0.0f) continue;
            const float gr = radial<kApprox>(r2, rad);
            const float tx = __fmul_rn(gr, dxv), ty = __fmul_rn(gr, dyv), tz = __fmul_rn(gr, dzv);
            ax += tx;
            ay += ty;
            az += tz;
            const size_t d = blk + static_cast<size_t>(j0 + jj) * nlane + sl;
            atomicAdd(o + d, -tx);
            atomicAdd(o + T + d, -ty);
            atomicAdd(o + 2 * T + d, -tz);
          }
        }
      }
    }
  }

  if (!active) return;
  if (S > 0) {
    float ccx = 0.0f, ccy = 0.0f, ccz = 0.0f;
    const float iLx = 1.0f / g.Lx, iLy = 1.0f / g.Ly, iLz = 1.0f / g.Lz;
    if (cellcenter) {
      const float csx = g.Lx / g.nx, csy = g.Ly / ny, csz = g.Lz / g.nz;
      ccx = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(cx), 0.5f), csx), 0.5f * g.Lx);
      ccy = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(cy), 0.5f), csy), 0.5f * g.Ly);
      ccz = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(zc), 0.5f), csz), 0.5f * g.Lz);
    }
    for (int s = 0; s < S; ++s) {
      const float sx = sstrag[s], sy = sstrag[S + s], sz = sstrag[2 * S + s];
      const float sval = sstrag[3 * S + s];
      float dxv, dyv, dzv, gr;
      if (cellcenter) {
        dxv = __fsub_rn(sx, __fmul_rn(g.Lx, rintf(__fmul_rn(__fsub_rn(sx, ccx), iLx)))) - xi;
        dyv = __fsub_rn(sy, __fmul_rn(g.Ly, rintf(__fmul_rn(__fsub_rn(sy, ccy), iLy)))) - yi;
        dzv = __fsub_rn(sz, __fmul_rn(g.Lz, rintf(__fmul_rn(__fsub_rn(sz, ccz), iLz)))) - zi;
        gr = __fmul_rn(radial<kApprox>(dist2(dxv, dyv, dzv), rad), sval);
      } else {
        dxv = sx - xi;
        dyv = sy - yi;
        dzv = sz - zi;
        dxv = __fsub_rn(dxv, __fmul_rn(g.Lx, rintf(__fmul_rn(dxv, iLx))));
        dyv = __fsub_rn(dyv, __fmul_rn(g.Ly, rintf(__fmul_rn(dyv, iLy))));
        dzv = __fsub_rn(dzv, __fmul_rn(g.Lz, rintf(__fmul_rn(dzv, iLz))));
        const float r2 = dist2(dxv, dyv, dzv);
        gr = (r2 < rad.rc2 && sval > 0.5f && xi < 1.0e8f) ? radial<kApprox>(r2, rad) : 0.0f;
      }
      if (gr == 0.0f) continue;
      const float tx = __fmul_rn(gr, dxv), ty = __fmul_rn(gr, dyv), tz = __fmul_rn(gr, dzv);
      ax += tx;
      ay += ty;
      az += tz;
      atomicAdd(sforce + 3 * s, -tx);
      atomicAdd(sforce + 3 * s + 1, -ty);
      atomicAdd(sforce + 3 * s + 2, -tz);
    }
  }
  atomicAdd(out + hidx, ax);
  atomicAdd(out + T + hidx, ay);
  atomicAdd(out + 2 * T + hidx, az);
}

template <bool kHalo>
int launch(const float* x, const float* y, const float* z, const float* gx, const float* gy,
           const float* gz, const float* strag, float* out, float* sforce, const Geom& g,
           const Radial& rad, int S, int self_half, int cellcenter, int approx, void* stream) {
  int rows = 512 / g.nlane;
  rows = rows < 1 ? 1 : (rows > g.cap ? g.cap : rows);
  const dim3 block(g.nlane, rows);
  const dim3 grid((g.cap + rows - 1) / rows, g.nyb, g.nz);
  const size_t smem = sizeof(float) * (9 * kJ * g.nlane + 4 * S);
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

// strag: float32 [4, S] (x, y, z, valid) or null when S == 0.
extern "C" int uammd_newton_pair(void* x, void* y, void* z, void* strag, void* out,
                                 void* sforce, int nx, int nyb, int nz, int F,
                                 int cap, int S, int self_half, int cellcenter,
                                 int approx, float Lx, float Ly, float Lz,
                                 float c1, float c2, float rc2, float lo,
                                 void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz};
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
                                      float rc2, float lo, void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz};
  return launch<true>(cf(x), cf(y), cf(z), cf(gx), cf(gy), cf(gz), cf(strag),
                      static_cast<float*>(out), static_cast<float*>(sforce), g,
                      Radial{c1, c2, rc2, lo}, S, self_half, 0, approx, stream);
}

// Short-range LJ pair force on the grid-resident layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/pair_kernel.py:
// make_pair_force_kernel (pallas_call at :272), in two modes.
//
// Force only (:192-205, entry uammd_pair_force): for every home slot
// (z, yb, c, lane) it sums g(r2) * d over ALL CAP slots of all 27 neighbor
// cells (home cell and self slot included), with d = r_j - r_i after the
// periodic image shift, r2s = max(r2, clamp_lo) and
// g = r2 < rc2 ? lj_g(r2s) : 0. Self and empty slots contribute exactly 0:
// d = 0 for the self slot, and empty slots sit at EMPTY_POS = 1e9 so their
// r2 ~ 1e18 fails the cutoff. Empty *home* slots get finite garbage that
// the caller masks.
//
// Observables (:206-231, entry uammd_pair_force_obs): the force, the
// per-particle energy (half of lj_e(r2) per pair, e_shift subtracted), the
// virial (sum of -g r2 / 2) and the six stress components (xx, xy, xz, yy,
// yz, zz of -g d_a d_b / 2; trace = virial). As in the JAX kernel this mode
// drops the clamp and masks with inside = r2 < rc2 && r2 > 1e-10: the
// radial is evaluated only inside. Eleven sums per home slot, in registers.
//
// Halo (:99-102, :142-146, entry uammd_pair_force_halo): the force-only mode
// on a z-slab of parallel/domain.py, extended by one ghost row at each end
// whose z the caller has image-shifted. The z index still wraps, but no Lz
// shift is applied; the ghost rows' own outputs are garbage the caller drops.
//
// Layout: arrays are [nz, nyb, CAP, NLANE] float32; lane l = cx*F + f is
// cell (cx, y = yb*F + f). All geometry is a runtime argument (NLANE is 128
// at the benchmark spec but 16 or 48 at test sizes).
//
// Design: one thread per home slot. A block owns `rows` home rows of one
// (z, yb) block across all NLANE lanes (blockDim = (NLANE, rows)); for each
// dz it stages kJ candidate rows of the three source y-blocks (yb-1, yb,
// yb+1) of the z-slab in shared memory (9*kJ*NLANE floats, 36 KB at
// NLANE 128), and every thread walks the 9 (dy, dx) cells of its lane over
// the staged rows. Neighbouring lanes read neighbouring shared addresses.
//
// What bounds it: arithmetic (the observable mode adds 14 operations per
// pair inside the cutoff, off the hot path). At the 2^20 benchmark spec ([42,10,40,128])
// one call evaluates 27*CAP^2*NLANE*nz*nyb = 2.3e9 padded pair slots of
// ~25 float32 instructions each, including an IEEE division, while it
// moves only 6 x 8.6 MB. Only about a quarter of the slots hold a particle
// (mean occupancy 19.5 of CAP 40), and each pair is evaluated twice;
// skipping empty rows and Newton halving are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kJ = 8;  // candidate rows staged per pass

struct Geom {
  int nx, nyb, nz, F, cap, nlane;
  float Lx, Ly, Lz;
  int periodic_z;  // 0: z-slab halo mode, the z index wraps but takes no Lz shift
};

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

__device__ __forceinline__ int wrap_index(int s, int n, float L, float* shift) {
  if (s < 0) { *shift = -L; return s + n; }
  if (s >= n) { *shift = L; return s - n; }
  *shift = 0.0f;
  return s;
}

// OBS: obs holds the 8 grids energy, virial, stress x 6, each
// T = nz * nyb * CAP * NLANE floats apart.
template <bool OBS>
__global__ void pair_force_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, float* __restrict__ fx,
    float* __restrict__ fy, float* __restrict__ fz, float* __restrict__ obs, Geom g,
    float rc2, float clamp_lo, float neg24eps, float s2, float c4eps, float e_shift) {
  extern __shared__ float smem[];  // [3 y-blocks][3 coords][kJ][nlane]
  const int nlane = g.nlane;
  const int lane = threadIdx.x;
  const int c = blockIdx.x * blockDim.y + threadIdx.y;
  const int yb = blockIdx.y;
  const int zc = blockIdx.z;
  const bool home = c < g.cap;
  const int cx = lane / g.F;
  const int f = lane - cx * g.F;
  const int ny = g.nyb * g.F;
  const int cy = yb * g.F + f;
  const size_t plane = static_cast<size_t>(g.cap) * nlane;  // one [CAP, NLANE] block
  const size_t hidx =
      (static_cast<size_t>(zc) * g.nyb + yb) * plane + static_cast<size_t>(c) * nlane + lane;

  float xi = 0.0f, yi = 0.0f, zi = 0.0f;
  if (home) {
    xi = x[hidx];
    yi = y[hidx];
    zi = z[hidx];
  }
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  float en = 0.0f, vir = 0.0f, st[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int coord_stride = kJ * nlane;

  for (int dz = -1; dz <= 1; ++dz) {
    float shz;
    const int sz = wrap_index(zc + dz, g.nz, g.Lz, &shz);
    if (!g.periodic_z) shz = 0.0f;
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
        smem[(b * 3 + 0) * coord_stride + r] = x[src];
        smem[(b * 3 + 1) * coord_stride + r] = y[src];
        smem[(b * 3 + 2) * coord_stride + r] = z[src];
      }
      __syncthreads();
      if (!home) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        float shy;
        const int sy = wrap_index(cy + dy, ny, g.Ly, &shy);
        const int sf = sy % g.F;
        // staged y-block of the source row: yb-1, yb or yb+1
        const int b = (f + dy < 0) ? 0 : ((f + dy >= g.F) ? 2 : 1);
        for (int dx = -1; dx <= 1; ++dx) {
          float shx;
          const int sx = wrap_index(cx + dx, g.nx, g.Lx, &shx);
          const int sl = sx * g.F + sf;
          const float* sX = smem + (b * 3 + 0) * coord_stride + sl;
          const float* sY = smem + (b * 3 + 1) * coord_stride + sl;
          const float* sZ = smem + (b * 3 + 2) * coord_stride + sl;
          for (int jj = 0; jj < nj; ++jj) {
            const float dxv = (sX[jj * nlane] + shx) - xi;
            const float dyv = (sY[jj * nlane] + shy) - yi;
            const float dzv = (sZ[jj * nlane] + shz) - zi;
            // r2 rounded as the plain version rounds it, (dx^2 + dy^2) + dz^2
            // without FMA: the unshifted LJ force jumps by 0.039 at rc, so an
            // r2 rounded differently could move a pair across the cutoff.
            const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dxv, dxv), __fmul_rn(dyv, dyv)),
                                       __fmul_rn(dzv, dzv));
            if (OBS) {
              if (!(r2 < rc2 && r2 > 1e-10f)) continue;
              const float gr = lj_g(r2, neg24eps, s2);
              ax += gr * dxv;
              ay += gr * dyv;
              az += gr * dzv;
              en += lj_e(r2, c4eps, s2, e_shift);
              const float hg = -0.5f * gr;
              vir += hg * r2;
              st[0] += hg * dxv * dxv;
              st[1] += hg * dxv * dyv;
              st[2] += hg * dxv * dzv;
              st[3] += hg * dyv * dyv;
              st[4] += hg * dyv * dzv;
              st[5] += hg * dzv * dzv;
              continue;
            }
            // Branch around the division only: a NaN r2 still reaches the
            // sums through 0 * NaN, as in the TPU kernel's select.
            float gr = 0.0f;
            if (r2 < rc2) gr = lj_g(fmaxf(r2, clamp_lo), neg24eps, s2);
            ax += gr * dxv;
            ay += gr * dyv;
            az += gr * dzv;
          }
        }
      }
    }
  }
  if (home) {
    fx[hidx] = ax;
    fy[hidx] = ay;
    fz[hidx] = az;
    if (OBS) {
      const size_t T = static_cast<size_t>(g.nz) * g.nyb * plane;
      obs[hidx] = 0.5f * en;
      obs[T + hidx] = vir;
#pragma unroll
      for (int k = 0; k < 6; ++k) obs[(2 + k) * T + hidx] = st[k];
    }
  }
}

template <bool OBS>
int launch(void* x, void* y, void* z, void* fx, void* fy, void* fz, void* obs, const Geom& g,
           float rc2, float clamp_lo, float neg24eps, float s2, float c4eps, float e_shift,
           void* stream) {
  int rows = 512 / g.nlane;
  rows = rows < 1 ? 1 : (rows > g.cap ? g.cap : rows);
  const dim3 block(g.nlane, rows);
  const dim3 grid((g.cap + rows - 1) / rows, g.nyb, g.nz);
  const size_t smem = sizeof(float) * 9 * kJ * g.nlane;
  pair_force_kernel<OBS><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(z), static_cast<float*>(fx), static_cast<float*>(fy),
      static_cast<float*>(fz), static_cast<float*>(obs), g, rc2, clamp_lo, neg24eps, s2, c4eps,
      e_shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int uammd_pair_force(void* x, void* y, void* z, void* fx, void* fy,
                                void* fz, int nx, int nyb, int nz, int F,
                                int cap, float Lx, float Ly, float Lz,
                                float rc2, float clamp_lo, float neg24eps,
                                float s2, void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, 1};
  return launch<false>(x, y, z, fx, fy, fz, nullptr, g, rc2, clamp_lo, neg24eps, s2, 0.0f, 0.0f,
                       stream);
}

// The halo mode of parallel/domain.py (pair_kernel.py:89, periodic_z=False):
// x, y, z are a z-slab extended by one ghost row at each end, whose z the
// caller has image-shifted; the caller drops the ghost rows of the output.
extern "C" int uammd_pair_force_halo(void* x, void* y, void* z, void* fx, void* fy, void* fz,
                                     int nx, int nyb, int nz, int F, int cap, float Lx,
                                     float Ly, float Lz, float rc2, float clamp_lo,
                                     float neg24eps, float s2, void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, 0};
  return launch<false>(x, y, z, fx, fy, fz, nullptr, g, rc2, clamp_lo, neg24eps, s2, 0.0f, 0.0f,
                       stream);
}

// obs: float32 [8, T] (energy, virial, stress xx xy xz yy yz zz).
extern "C" int uammd_pair_force_obs(void* x, void* y, void* z, void* fx, void* fy, void* fz,
                                    void* obs, int nx, int nyb, int nz, int F, int cap, float Lx,
                                    float Ly, float Lz, float rc2, float neg24eps, float s2,
                                    float c4eps, float e_shift, void* stream) {
  const Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, 1};
  return launch<true>(x, y, z, fx, fy, fz, obs, g, rc2, 0.0f, neg24eps, s2, c4eps, e_shift,
                      stream);
}

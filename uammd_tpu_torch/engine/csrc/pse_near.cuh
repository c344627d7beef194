// The PSE near-field pair functor shared by the channel kernels
// (pair_channel.cu, newton_channel.cu), and their shared geometry.
//
// Device form of uammd_tpu_torch/engine/pse_near.py:PSENear (the JAX
// package's pse_engine.py:263-335). For a pair at d = r_j - r_i:
//   inside = r2 < rc2 && r2 > 1e-10
//   q = (r2 * rsqrt(r2)) * (1/rcut); piece 1 if q < qb, else piece 2
//   f, g = Horner of the piece's 13 coefficients in u = a q + b
//   forward onto i:  f F_j + (g / r2)(d . F_j) d
//   reverse onto j:  f F_i + (g / r2)(d . F_i) d
// r2 and q are rounded with __fmul_rn / __fadd_rn as the plain version
// rounds them (no FMA contraction): the remainder jumps by about the
// tolerance at rcut and by the fit error at qb, so a differently rounded r2
// or q would move a pair across an edge. The Horner steps use FMAs, and
// rsqrtf may differ from torch.rsqrt by an ulp: both stay far inside the
// checks' 2e-5 x max|ref|.

#pragma once

#include <cuda_runtime.h>

namespace pse {

constexpr int kNCoef = 13;
constexpr float kEmptyLimit = 1.0e8f;  // slots at EMPTY_POS = 1e9 are empty

struct Near {
  float c[4 * kNCoef];  // f1, f2, g1, g2; lowest degree first, zero padded
  float a1, b1, a2, b2, qb, rc2, inv_rcut;
};

struct Geom {
  int nx, nyb, nz, F, cap, nlane;
  float Lx, Ly, Lz, iLx, iLy, iLz;  // iL = float32(1 / L), as the JAX kernel's constants
};

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// (f, g / r2) of a pair; false when the pair contributes nothing.
__device__ __forceinline__ bool radial(float r2, const Near& p, float* f, float* ginv2) {
  if (!(r2 < p.rc2 && r2 > 1e-10f)) return false;
  const float rinv = rsqrtf(r2);
  const float q = __fmul_rn(__fmul_rn(r2, rinv), p.inv_rcut);
  const bool near = q < p.qb;
  const float u = near ? __fadd_rn(__fmul_rn(p.a1, q), p.b1)
                       : __fadd_rn(__fmul_rn(p.a2, q), p.b2);
  float af = near ? p.c[kNCoef - 1] : p.c[2 * kNCoef - 1];
  float ag = near ? p.c[3 * kNCoef - 1] : p.c[4 * kNCoef - 1];
#pragma unroll
  for (int k = kNCoef - 2; k >= 0; --k) {
    af = fmaf(af, u, near ? p.c[k] : p.c[kNCoef + k]);
    ag = fmaf(ag, u, near ? p.c[2 * kNCoef + k] : p.c[3 * kNCoef + k]);
  }
  *f = af;
  *ginv2 = ag * (rinv * rinv);
  return true;
}

// Adds f F + ginv2 (d . F) d of the NV 3-vectors in F[3 NV] to acc[3 NV].
template <int NV>
__device__ __forceinline__ void apply(float f, float ginv2, float dx, float dy, float dz,
                                      const float* F, float* acc) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const float fx = F[3 * k], fy = F[3 * k + 1], fz = F[3 * k + 2];
    const float gc = ginv2 * (fx * dx + fy * dy + fz * dz);
    acc[3 * k] += f * fx + gc * dx;
    acc[3 * k + 1] += f * fy + gc * dy;
    acc[3 * k + 2] += f * fz + gc * dz;
  }
}

// The displacements of a home coordinate xi and a straggler row's xs, each
// rounded as the grid rounds a candidate of an image cell: with the minimum
// image's shift L rint((xs - xi) / L) (the float32 1/L), *fwd = (xs - shift)
// - xi from the home slot and *rev = (xi + shift) - xs from the row, so that
// a pair gives the same value whether its partner is a straggler or a grid
// particle.
__device__ __forceinline__ void image_pair(float xs, float xi, float L, float iL, float* fwd,
                                           float* rev) {
  const float shift = __fmul_rn(L, rintf(__fmul_rn(__fsub_rn(xs, xi), iL)));
  *fwd = __fsub_rn(__fsub_rn(xs, shift), xi);
  *rev = __fsub_rn(__fadd_rn(xi, shift), xs);
}

__device__ __forceinline__ int wrap_index(int s, int n, float L, float* shift) {
  if (s < 0) { *shift = -L; return s + n; }
  if (s >= n) { *shift = L; return s - n; }
  *shift = 0.0f;
  return s;
}

}  // namespace pse

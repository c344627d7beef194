// Pair functors of the 27-stencil channel kernel (pair_channel.cu), one per
// transverser of the JAX package that runs make_pair_channel_kernel:
//
//   PSEFn<NV>       the PSE near-field RPY remainder (pse_near.cuh), NV = 1, 2
//   DPDFn           uammd_tpu/engine/dpd.py:dpd_pair_fn            (4 + 1 in, 3 out)
//   SPHDensityFn    uammd_tpu/engine/sph.py:sph_density_pair_fn    (1 in, 1 out)
//   SPHForceFn      uammd_tpu/engine/sph.py:sph_force_pair_fn      (5 in, 3 out)
//   LJMixFn<MASKED> uammd_tpu/engine/mixtures.py:lj_mixture_pair_fn (2 in, 3 out)
//                   and lj_mixture_pair_fn_masked                  (3 in, 3 out)
//   PoissonFn       uammd_tpu/electrostatics/poisson.py:GaussianNearField._pair_fn
//                                                                  (1 in, 4 out)
//   RadialForceFn   uammd_tpu/parallel/pse_dd2.py:115-127, g(r2) d with the
//                   fused LJ radial md.lj_g_fused                  (0 in, 3 out)
//
// A functor declares NG grid channels (staged for home and candidate slots),
// NU uniform channels (home side only, one value for the whole launch: the
// DPD step counter), NOUT sums, and kStrag when it also serves the straggler
// block. fwd(r2, d, ci, cj, cs, acc) adds the contributions of candidate j
// onto home i to acc[NOUT]: ci holds the home's NG + NU channels, cj points
// at the candidate's first channel with stride cs (the grid's slots in
// device memory, or a straggler row's in shared memory). Each
// functor returns early outside its cutoff (and on the self pair), where
// the JAX pair_fn selects 0; its plain PyTorch form, with the JAX pair_fn
// signature, is in the Python module named beside it.
//
// What the kernel reads besides fwd:
//   kDisp        which sums carry the displacement: 0 none (SPH density),
//                1 sum k < 3 carries d_k alone (DPD, SPH force, the
//                mixtures, Poisson's first three), 2 every sum carries
//                all of d (PSE: f F + (g / r2)(d . F) d). The JAX pair_fn
//                multiplies a zero coefficient by d outside the cutoff, so
//                a pair whose d is not finite puts 0 * d_k = NaN into
//                exactly those sums (zero_terms in pair_channel.cu).
//   reach(hs)    the largest distance at which fwd can add a term (the
//                kernel's cutoff cull); thr2(hs) an r2 below which every
//                pair that fwd counts lies. hs is the largest sum of two
//                half_sigma channels (kReachChan, the mixtures) and is
//                ignored by the functors with a fixed cutoff, whose thr2
//                is their own cutoff^2 bit for bit.
//
// Bit-level edges: r2 comes rounded as the plain version rounds it
// (pse::dist2), and so does the mixture's per-pair cutoff
// rc2 = cs2 (hs_i + hs_j)^2, at which the truncated LJ force jumps, and the
// Poisson functor's q = r / rcut and u = a q + b, whose polynomial pieces
// meet at qb up to the fit error, and its Horner steps. DPD's
// weight and SPH's kernel are continuous at their cutoffs. The DPD pair
// noise is an integer counter hash, equal bit for bit to JAX's.

#pragma once

#include <cstddef>
#include <cstdint>

#include "pse_near.cuh"

namespace chan {

template <int NV>
struct PSEFn {
  static constexpr int NG = 3 * NV;
  static constexpr int NU = 0;
  static constexpr int NOUT = 3 * NV;
  static constexpr bool kStrag = true;
  static constexpr int kDisp = 2;
  static constexpr int kReachChan = -1;
  pse::Near p;

  __device__ __forceinline__ float reach(float) const { return sqrtf(p.rc2); }
  __device__ __forceinline__ float thr2(float) const { return p.rc2; }

  __device__ __forceinline__ void fwd(float r2, float dx, float dy, float dz, const float*,
                                      const float* cj, size_t cs, float* acc) const {
    float fr, gr;
    if (!pse::radial(r2, p, &fr, &gr)) return;
    float Fj[NG];
#pragma unroll
    for (int k = 0; k < NG; ++k) Fj[k] = cj[k * cs];
    pse::apply<NV>(fr, gr, dx, dy, dz, Fj, acc);
  }
};

// ---------------------------------------------------------------- DPD hash
// uammd_tpu/engine/dpd.py:45-69: a murmur3-style finalizer on 32-bit words
// (the JAX code holds them in int32 with logical shifts).
__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t absorb(uint32_t h, uint32_t w) {
  return mix(h ^ w) * 0x01000193u + 0x6A09E667u;
}

__device__ __forceinline__ uint32_t hash2(uint32_t a, uint32_t b) {
  return mix(absorb(absorb(0x9E3779B9u, a), b));
}

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
  return mix(absorb(absorb(absorb(0x9E3779B9u, a), b), c));
}

// top 24 bits -> uniform [0, 1)
__device__ __forceinline__ float u24f(uint32_t h) {
  return static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
}

struct DPDParams {
  float rc2, inv_rc, A, gamma, sigma, sq6;
};

// channels (vx, vy, vz, pid) per slot, and the step counter (as float32, the
// JAX engine's step channel) as a uniform
struct DPDFn {
  static constexpr int NG = 4;
  static constexpr int NU = 1;
  static constexpr int NOUT = 3;
  static constexpr bool kStrag = false;
  static constexpr int kDisp = 1;
  static constexpr int kReachChan = -1;
  DPDParams p;

  __device__ __forceinline__ float reach(float) const { return sqrtf(p.rc2); }
  __device__ __forceinline__ float thr2(float) const { return p.rc2; }

  __device__ __forceinline__ void fwd(float r2, float dx, float dy, float dz, const float* ci,
                                      const float* cj, size_t cs, float* acc) const {
    if (!(r2 < p.rc2 && r2 > 1e-10f)) return;
    const float rinv = rsqrtf(r2);
    const float w = 1.0f - __fmul_rn(__fmul_rn(r2, rinv), p.inv_rc);
    const float vdotr =
        ((cj[0] - ci[0]) * dx + (cj[cs] - ci[1]) * dy + (cj[2 * cs] - ci[2]) * dz) * rinv;
    const int ii = static_cast<int>(ci[3]);
    const int jj = static_cast<int>(cj[3 * cs]);
    const uint32_t c = hash2(static_cast<uint32_t>(min(ii, jj)),
                             static_cast<uint32_t>(max(ii, jj)));
    const uint32_t st = static_cast<uint32_t>(static_cast<int>(ci[4]));
    const float u1 = u24f(hash3(c, st, 0x00BEEF01u));
    const float u2 = u24f(hash3(c, st, 0x00F00D02u));
    const float xi = p.sq6 * ((u1 + u2) - 1.0f);
    const float fmod = p.A * w - p.gamma * w * w * vdotr + p.sigma * w * xi;
    const float f = -fmod * rinv;
    acc[0] += f * dx;
    acc[1] += f * dy;
    acc[2] += f * dz;
  }
};

// ---------------------------------------------------------------- SPH
// cubic spline of support 2h (uammd_tpu/interactors/sph.py:29-48)
struct SPHParams {
  float cut2, h, norm3, norm4, nu;  // norm3 = 4 pi h^3, norm4 = 4 pi h^4 (float32)
};

struct SPHDensityFn {
  static constexpr int NG = 1;  // mass
  static constexpr int NU = 0;
  static constexpr int NOUT = 1;
  static constexpr bool kStrag = false;
  static constexpr int kDisp = 0;
  static constexpr int kReachChan = -1;
  SPHParams p;

  __device__ __forceinline__ float reach(float) const { return sqrtf(p.cut2); }
  __device__ __forceinline__ float thr2(float) const { return p.cut2; }

  __device__ __forceinline__ void fwd(float r2, float, float, float, const float*,
                                      const float* cj, size_t, float* acc) const {
    if (!(r2 < p.cut2 && r2 > 1e-12f)) return;
    const float q = sqrtf(__fadd_rn(r2, 1e-32f)) / p.h;
    const float twomq = fmaxf(2.0f - q, 0.0f);
    const float onemq = fmaxf(1.0f - q, 0.0f);
    const float w = twomq * twomq * twomq - 4.0f * (onemq * onemq * onemq);
    acc[0] += cj[0] * (w / p.norm3);
  }
};

// channels (P / rho^2, vx, vy, vz, mass)
struct SPHForceFn {
  static constexpr int NG = 5;
  static constexpr int NU = 0;
  static constexpr int NOUT = 3;
  static constexpr bool kStrag = false;
  static constexpr int kDisp = 1;
  static constexpr int kReachChan = -1;
  SPHParams p;

  __device__ __forceinline__ float reach(float) const { return sqrtf(p.cut2); }
  __device__ __forceinline__ float thr2(float) const { return p.cut2; }

  __device__ __forceinline__ void fwd(float r2, float dx, float dy, float dz, const float* ci,
                                      const float* cj, size_t cs, float* acc) const {
    if (!(r2 < p.cut2 && r2 > 1e-12f)) return;
    const float dvdotdr =
        (cj[cs] - ci[1]) * dx + (cj[2 * cs] - ci[2]) * dy + (cj[3 * cs] - ci[3]) * dz;
    const float visc = (-p.nu * dvdotdr) / __fadd_rn(r2, 1e-3f);
    const float r = sqrtf(__fadd_rn(r2, 1e-32f));
    const float q = r / p.h;
    const float twomq = fmaxf(2.0f - q, 0.0f);
    const float onemq = fmaxf(1.0f - q, 0.0f);
    const float dwdq = -3.0f * (twomq * twomq) + 12.0f * (onemq * onemq);
    const float gw = dwdq / (p.norm4 * fmaxf(r, 1e-10f));
    const float fmod = ci[4] * cj[4 * cs] * ((ci[0] + cj[0]) + visc) * gw;
    acc[0] += fmod * dx;
    acc[1] += fmod * dy;
    acc[2] += fmod * dz;
  }
};

// ---------------------------------------------------------------- LJ mixtures
struct LJMixParams {
  float cs2, lo;  // cut_scale^2, clamp_lo
};

// channels (sqrt eps, sigma / 2[, small flag]); MASKED drops the pairs whose
// two particles are both small (the fine grid's pairs)
template <bool MASKED>
struct LJMixFn {
  static constexpr int NG = MASKED ? 3 : 2;
  static constexpr int NU = 0;
  static constexpr int NOUT = 3;
  static constexpr bool kStrag = false;
  static constexpr int kDisp = 1;
  static constexpr int kReachChan = 1;  // half_sigma
  LJMixParams p;

  // the per-pair cutoff sqrt(cs2) (hs_i + hs_j) is below reach(hs) for any
  // pair whose half_sigma sum is at most hs; thr2 adds the cull's margin
  __device__ __forceinline__ float reach(float hs) const { return sqrtf(p.cs2) * hs; }
  __device__ __forceinline__ float thr2(float hs) const {
    const float c = reach(hs) + 1.0e-2f;
    return c * c;
  }

  __device__ __forceinline__ void fwd(float r2, float dx, float dy, float dz, const float* ci,
                                      const float* cj, size_t cs, float* acc) const {
    const float sig = ci[1] + cj[cs];
    const float sig2 = __fmul_rn(sig, sig);
    // empty slots carry zero channels: rc2 = 0, never inside
    if (!(r2 < __fmul_rn(p.cs2, sig2) && r2 > 1e-10f)) return;
    const float eps = ci[0] * cj[0];
    const float t = sig2 / fmaxf(r2, __fmul_rn(p.lo, sig2));
    const float t6 = t * t * t;
    float g = (-24.0f * eps / fmaxf(r2, p.lo)) * (2.0f * t6 * t6 - t6);
    if (MASKED) g = (1.0f - ci[2] * cj[2 * cs]) * g;
    acc[0] += g * dx;
    acc[1] += g * dy;
    acc[2] += g * dz;
  }
};

// ---------------------------------------------------------------- Poisson
// The Ewald near-field correction of the split spectral Poisson solver: G
// and G'/r of the difference of two Gaussian-charge Green's functions as
// two-piece polynomials of degree up to kPoissonNCoef - 1 in u = a q + b,
// q = r / rcut, pieces split at qb.
constexpr int kPoissonNCoef = 21;

struct PoissonParams {
  float c[4 * kPoissonNCoef];  // e1, e2, g1, g2; lowest degree first, zero padded
  float a1, b1, a2, b2, qb, rc2, inv_rcut;
};

// channel (charge q); sums (q_j g dx, q_j g dy, q_j g dz, q_j G) onto i
struct PoissonFn {
  static constexpr int NG = 1;
  static constexpr int NU = 0;
  static constexpr int NOUT = 4;
  static constexpr bool kStrag = true;
  static constexpr int kDisp = 1;  // the fourth sum, q_j G, carries no displacement
  static constexpr int kReachChan = -1;
  PoissonParams p;

  __device__ __forceinline__ float reach(float) const { return sqrtf(p.rc2); }
  __device__ __forceinline__ float thr2(float) const { return p.rc2; }

  // (g, e) of a pair inside the cutoff; false otherwise (and on the self pair)
  __device__ __forceinline__ bool radial(float r2, float* g, float* e) const {
    if (!(r2 < p.rc2 && r2 > 1e-10f)) return false;
    const float rinv = rsqrtf(r2);
    const float q = __fmul_rn(__fmul_rn(r2, rinv), p.inv_rcut);
    const bool near = q < p.qb;
    const float u = near ? __fadd_rn(__fmul_rn(p.a1, q), p.b1)
                         : __fadd_rn(__fmul_rn(p.a2, q), p.b2);
    constexpr int N = kPoissonNCoef;
    float ae = near ? p.c[N - 1] : p.c[2 * N - 1];
    float ag = near ? p.c[3 * N - 1] : p.c[4 * N - 1];
    // rounded as the plain version rounds them (no FMA): the power-basis
    // coefficients of a degree-20 fit cancel, so a contracted Horner step
    // moves the sum by about 1e-4 of its size
#pragma unroll
    for (int k = N - 2; k >= 0; --k) {
      ae = __fadd_rn(__fmul_rn(ae, u), near ? p.c[k] : p.c[N + k]);
      ag = __fadd_rn(__fmul_rn(ag, u), near ? p.c[2 * N + k] : p.c[3 * N + k]);
    }
    *g = ag;
    *e = ae;
    return true;
  }

  __device__ __forceinline__ void fwd(float r2, float dx, float dy, float dz, const float*,
                                      const float* cj, size_t, float* acc) const {
    float g, e;
    if (!radial(r2, &g, &e)) return;
    const float gq = g * cj[0];
    acc[0] += gq * dx;
    acc[1] += gq * dy;
    acc[2] += gq * dz;
    acc[3] += e * cj[0];
  }
};

// ---------------------------------------------------------------- radial force
// The fused LJ radial of uammd_tpu/engine/md.py:lj_g_fused (md.LJFused):
// g = r2 < rc2 ? t^4 (c1 t^3 + c2) : 0 with t = 1 / max(r2, lo), rounded as
// the plain version rounds it (no FMA); approx takes rcp.approx.ftz.f32 for
// the division, as the Newton pair kernel does.
struct RadialParams {
  float c1, c2, rc2, lo;
  int approx;
};

// no channels; sums g(r2) d onto i (the reverse direction is the same body
// on the row's own displacement, -d rounded as a grid candidate's). The
// clamp keeps the self pair's g finite, and its d = 0 adds nothing.
struct RadialForceFn {
  static constexpr int NG = 0;
  static constexpr int NU = 0;
  static constexpr int NOUT = 3;
  static constexpr bool kStrag = true;
  static constexpr int kDisp = 1;
  static constexpr int kReachChan = -1;
  RadialParams p;

  __device__ __forceinline__ float reach(float) const { return sqrtf(p.rc2); }
  __device__ __forceinline__ float thr2(float) const { return p.rc2; }

  __device__ __forceinline__ void fwd(float r2, float dx, float dy, float dz, const float*,
                                      const float*, size_t, float* acc) const {
    if (!(r2 < p.rc2)) return;
    const float r2c = fmaxf(r2, p.lo);
    float t;
    if (p.approx) {
      asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(r2c));
    } else {
      t = __fdiv_rn(1.0f, r2c);
    }
    const float t2 = __fmul_rn(t, t);
    const float t3 = __fmul_rn(t2, t);
    const float t4 = __fmul_rn(t2, t2);
    const float g = __fmul_rn(t4, __fadd_rn(__fmul_rn(p.c1, t3), p.c2));
    acc[0] += g * dx;
    acc[1] += g * dy;
    acc[2] += g * dz;
  }
};

}  // namespace chan

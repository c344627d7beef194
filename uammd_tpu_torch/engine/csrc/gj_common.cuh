// Device code shared by the two Gronbech-Jensen update kernels
// (gj_fold_update.cu, #12, and gj_update.cu, #11): the Philox-4x32-10
// counter hash, the two noise generators, the per-component update, the
// straggler-row update, a slot's drift and the drift's reduction over a
// launch, so that both kernels draw the same numbers for the same (seed,
// slot, stream), update the same way and take the same drift.
//
// Noise: Philox-4x32-10 (Random123's constants) under key (seed, 0) with
// counters (slot, 0, stream, 0) and (slot, 1, stream, 0); stream 0 for the
// grid slots, 1 for the straggler rows. The plain version is
// update_kernel.py:philox4x32. Every float operation is an explicit
// round-to-nearest intrinsic, so a kernel equals its plain version bit for
// bit where their math functions agree (always for "clt"; logf/sinf/cosf
// for "bm").
//
// Drift: JAX's rule as XLA compiles it (gj_update_jnp,
// uammd_tpu/engine/update_kernel.py:354; XLA turns mask * y into a select),
// the maximum over slots of where(mask, max(|x' - rx|, |y' - ry|,
// |z' - rz|), 0). Both maxima keep a NaN: they compare the int bits of
// non-negative floats, and a NaN's bits (its sign cleared by fabsf)
// exceed +inf's. An empty slot adds exactly 0, whatever it holds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gj {

struct Coef {
  float hv, bdt, c_x, dt, a, hva, bm, scale;
};

struct Strag {
  const float* pos;
  const float* vel;
  const float* force;
  const int* pid;  // occupied where pid >= 0 (null: pidf holds the rows' ids)
  float* pos_out;
  float* vel_out;
  const float* pidf = nullptr;  // pid + 1 as float32, occupied where > 0.5
  const float* ref = nullptr;   // [S, 3] positions at the last rebin: the rows' drift
};

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// three pseudo-normals: noise 0 = "clt" (scale = amp sqrt(3) / 65536),
// noise 1 = "bm" (scale = amp)
__device__ __forceinline__ void normals(uint32_t seed, uint32_t slot, uint32_t stream,
                                        int noise, float scale, float n[3]) {
  uint32_t w[8] = {slot, 0u, stream, 0u, slot, 1u, stream, 0u};
  philox4x32_10(w, seed, 0u);
  philox4x32_10(w + 4, seed, 0u);
  if (noise == 0) {
    float u[12];
    for (int d = 0; d < 6; ++d) {
      u[2 * d] = static_cast<float>(w[d] & 0xFFFFu);
      u[2 * d + 1] = static_cast<float>((w[d] >> 16) & 0xFFFFu);
    }
    for (int k = 0; k < 3; ++k)
      n[k] = __fmul_rn(scale, __fsub_rn(__fadd_rn(u[4 * k], u[4 * k + 1]),
                                        __fadd_rn(u[4 * k + 2], u[4 * k + 3])));
  } else {
    const float two_pi = 6.283185307179586f;
    float u[4];
    for (int d = 0; d < 4; ++d)
      u[d] = __fsub_rn(1.0f, __fmul_rn(static_cast<float>(w[d] >> 9), 1.1920928955078125e-7f));
    const float r1 = sqrtf(__fmul_rn(-2.0f, logf(u[0])));
    const float r2 = sqrtf(__fmul_rn(-2.0f, logf(u[2])));
    n[0] = __fmul_rn(scale, __fmul_rn(r1, cosf(__fmul_rn(two_pi, u[1]))));
    n[1] = __fmul_rn(scale, __fmul_rn(r1, sinf(__fmul_rn(two_pi, u[1]))));
    n[2] = __fmul_rn(scale, __fmul_rn(r2, cosf(__fmul_rn(two_pi, u[3]))));
  }
}

// (p', w') of one component: p + m (bdt v + c_x (dt f + n)) and
// m ((a v + hva f) + bm n) with v = w + hv f
__device__ __forceinline__ void update(const Coef& k, float p, float w, float f, float nse,
                                       float m, float* po, float* wo) {
  const float v = __fadd_rn(w, __fmul_rn(k.hv, f));
  const float step =
      __fadd_rn(__fmul_rn(k.bdt, v), __fmul_rn(k.c_x, __fadd_rn(__fmul_rn(k.dt, f), nse)));
  *po = __fadd_rn(p, __fmul_rn(m, step));
  *wo = __fmul_rn(m, __fadd_rn(__fadd_rn(__fmul_rn(k.a, v), __fmul_rn(k.hva, f)),
                               __fmul_rn(k.bm, nse)));
}

// The int bits of |d|: a non-negative float's order as an int, NaN above +inf.
__device__ __forceinline__ int abs_bits(float d) { return __float_as_int(fabsf(d)); }

// straggler row s: the same update with noise stream 1, occupied where pid
// >= 0 (the JAX engine's _strag_update, md2.py:190-213) or pidf > 0.5 (the
// DD2 state's pid + 1, JAX domain2.py:280-292). Returns the row's drift
// bits: where(occupied, max_c |spos'_c - ref_c|, 0) when st.ref is set
// (JAX domain2.py:409-413), else 0.
__device__ __forceinline__ int strag_row(const Strag& st, const Coef& k, int s, uint32_t seed,
                                         int noisy, int noise) {
  float nse[3] = {0.0f, 0.0f, 0.0f};
  if (noisy) normals(seed, static_cast<uint32_t>(s), 1u, noise, k.scale, nse);
  const bool occupied = st.pid != nullptr ? st.pid[s] >= 0 : st.pidf[s] > 0.5f;
  const float m = occupied ? 1.0f : 0.0f;
  int bits = 0;
  for (int c = 0; c < 3; ++c) {
    float po, wo;
    update(k, st.pos[3 * s + c], st.vel[3 * s + c], st.force[3 * s + c], nse[c], m, &po, &wo);
    st.pos_out[3 * s + c] = po;
    st.vel_out[3 * s + c] = wo;
    if (st.ref != nullptr) bits = max(bits, abs_bits(__fsub_rn(po, st.ref[3 * s + c])));
  }
  return occupied ? bits : 0;
}

// The maximum over the launch of each thread's drift bits: a warp max, the
// block's maximum into partial[block], then the last block to finish (an
// atomicInc ticket that wraps to 0, ready for the next launch) writes the
// maximum over the blocks into *drift. No buffer is zeroed a call: partial
// and the ticket are a scratch the caller zeroes once. Every thread of the
// block calls it, and the block is THREADS threads, whole warps.
template <int THREADS>
__device__ __forceinline__ void drift_reduce(int bits, int* __restrict__ partial,
                                             unsigned* __restrict__ ticket,
                                             int* __restrict__ drift) {
  __shared__ int warp_max[THREADS / 32];
  __shared__ bool last;
  bits = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = bits;
  __syncthreads();
  const unsigned nblocks = gridDim.x * gridDim.y;
  if (threadIdx.x < 32) {
    bits = threadIdx.x < THREADS / 32 ? warp_max[threadIdx.x] : 0;
    bits = __reduce_max_sync(0xffffffffu, bits);
    if (threadIdx.x == 0) {
      partial[blockIdx.y * gridDim.x + blockIdx.x] = bits;
      __threadfence();
      last = atomicInc(ticket, nblocks - 1) == nblocks - 1;  // wraps to 0 for the next call
    }
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  bits = 0;
  for (unsigned b = threadIdx.x; b < nblocks; b += THREADS) bits = max(bits, __ldcg(partial + b));
  bits = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = bits;
  __syncthreads();
  if (threadIdx.x < 32) {
    bits = threadIdx.x < THREADS / 32 ? warp_max[threadIdx.x] : 0;
    bits = __reduce_max_sync(0xffffffffu, bits);
    if (threadIdx.x == 0) *drift = bits;
  }
}

}  // namespace gj

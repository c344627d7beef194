// Fused reaction fold + Gronbech-Jensen Langevin update, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/update_kernel.py:
// make_gj_fold_update_kernel (pallas_call at :301), with its noise
// generators _clt_normals (:156) and _bm_normals (:184). Per slot:
//   f  = home + sum_g G_g[(z - dz_g) % nz, (yb - dyb_g) % nyb]  (fold.cu's order)
//   v  = w + hv f                      (complete the deferred half kick)
//   x' = x + m (bdt v + c_x (dt f + n))
//   w' = m ((a v + hva f) + bm n)      with m = (x < 1e8), the occupied mask
//   drift = max over slots of m * max(|x' - rx|, |y' - ry|, |z' - rz|)
// The noise n comes from Philox-4x32-10 (Random123's constants) under key
// (seed, 0) with counters (slot, 0, 0, 0) and (slot, 1, 0, 0): the TPU's
// hardware PRNG has no counterpart, and a counter hash lets the plain
// version (update_kernel.py:philox4x32) draw the same numbers. The seed is
// read from the device (GridState.step), so a step needs no host read for
// it. Every float operation is an explicit round-to-nearest intrinsic, so
// the kernel equals its plain version bit for bit where their math
// functions agree (always for "clt"; logf/sinf/cosf for "bm").
// The drift is a warp max, then atomicMax on the int bits of the
// non-negative float into a zeroed int32. S more threads apply the same
// update to the straggler rows (spos, svel, sforce [S, 3], spid [S]),
// with noise counters (s, j, 1, 0), occupied where spid >= 0; the JAX
// engine does this in separate jnp ops (md2.py:190-213).
//
// What bounds it: memory, 24 grid reads (x, y, z, w, home force, 12 group
// grids, the 3 reference positions) and 6 grid writes per call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Ins {
  // x, y, z, wx, wy, wz, hfx, hfy, hfz, 12 groups (3 + 3g + c), rx, ry, rz
  const float* p[24];
};

struct Outs {
  float* p[6];
};

struct Coef {
  float hv, bdt, c_x, dt, a, hva, bm, scale;
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

struct Strag {
  const float* pos;
  const float* vel;
  const float* force;
  const int* pid;
  float* pos_out;
  float* vel_out;
};

// three pseudo-normals: noise 0 = "clt" (scale = amp sqrt(3) / 65536),
// noise 1 = "bm" (scale = amp); stream 0 for grid slots, 1 for stragglers
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
__device__ __forceinline__ void gj(const Coef& k, float p, float w, float f, float nse,
                                   float m, float* po, float* wo) {
  const float v = __fadd_rn(w, __fmul_rn(k.hv, f));
  const float step =
      __fadd_rn(__fmul_rn(k.bdt, v), __fmul_rn(k.c_x, __fadd_rn(__fmul_rn(k.dt, f), nse)));
  *po = __fadd_rn(p, __fmul_rn(m, step));
  *wo = __fmul_rn(m, __fadd_rn(__fadd_rn(__fmul_rn(k.a, v), __fmul_rn(k.hva, f)),
                               __fmul_rn(k.bm, nse)));
}

__global__ void gj_fold_update_kernel(Ins in, Outs out, const int* __restrict__ seed_ptr,
                                      int* __restrict__ drift_bits, Strag st, int n, int S,
                                      int nz, int nyb, int plane, int noisy, int noise,
                                      Coef k) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  float dinf = 0.0f;
  if (idx >= n && idx < n + S) {
    const int s = idx - n;
    float nse[3] = {0.0f, 0.0f, 0.0f};
    if (noisy) normals(static_cast<uint32_t>(*seed_ptr), static_cast<uint32_t>(s), 1u, noise,
                       k.scale, nse);
    const float m = st.pid[s] >= 0 ? 1.0f : 0.0f;
    for (int c = 0; c < 3; ++c)
      gj(k, st.pos[3 * s + c], st.vel[3 * s + c], st.force[3 * s + c], nse[c], m,
         st.pos_out + 3 * s + c, st.vel_out + 3 * s + c);
  }
  if (idx < n) {
    const int rem = idx % plane;
    const int zyb = idx / plane;
    const int yb = zyb % nyb;
    const int zc = zyb / nyb;
    const int gdz[4] = {1, 1, 1, 0};
    const int gdyb[4] = {-1, 0, 1, 1};
    int src[4];
    for (int g = 0; g < 4; ++g) {
      const int sz = (zc - gdz[g] + nz) % nz;
      const int syb = (yb - gdyb[g] + nyb) % nyb;
      src[g] = (sz * nyb + syb) * plane + rem;
    }
    float nse[3] = {0.0f, 0.0f, 0.0f};
    if (noisy) normals(static_cast<uint32_t>(*seed_ptr), static_cast<uint32_t>(idx), 0u, noise,
                       k.scale, nse);
    const float m = in.p[0][idx] < 1.0e8f ? 1.0f : 0.0f;
    for (int c = 0; c < 3; ++c) {
      float f = in.p[6 + c][idx];
      for (int g = 0; g < 4; ++g) f = __fadd_rn(f, in.p[9 + 3 * g + c][src[g]]);
      float po, wo;
      gj(k, in.p[c][idx], in.p[3 + c][idx], f, nse[c], m, &po, &wo);
      out.p[c][idx] = po;
      out.p[3 + c][idx] = wo;
      dinf = fmaxf(dinf, fabsf(__fsub_rn(po, in.p[21 + c][idx])));
    }
    dinf = __fmul_rn(m, dinf);
  }
  // every lane of the warp reaches here; non-negative floats order as ints
  int bits = __float_as_int(dinf);
  bits = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) atomicMax(drift_bits, bits);
}

}  // namespace

// ins: host array of 24 device pointers, outs: of 6; seed: device int32;
// drift_bits: device int32[1], zeroed by the caller; strag_ins: spos, svel,
// sforce (float32 [S, 3]) and spid (int32 [S]); strag_outs: spos', svel';
// n = nz * nyb * plane.
extern "C" int uammd_gj_fold_update(void** ins, void** outs, void* seed, void* drift_bits,
                                    void** strag_ins, void** strag_outs, int n, int S,
                                    int nz, int nyb, int plane, int noisy, int noise,
                                    float hv, float bdt, float c_x, float dt, float a,
                                    float hva, float bm, float scale, void* stream) {
  Ins in;
  for (int q = 0; q < 24; ++q) in.p[q] = static_cast<const float*>(ins[q]);
  Outs out;
  for (int q = 0; q < 6; ++q) out.p[q] = static_cast<float*>(outs[q]);
  const Strag st{static_cast<const float*>(strag_ins[0]), static_cast<const float*>(strag_ins[1]),
                 static_cast<const float*>(strag_ins[2]), static_cast<const int*>(strag_ins[3]),
                 static_cast<float*>(strag_outs[0]), static_cast<float*>(strag_outs[1])};
  const Coef k{hv, bdt, c_x, dt, a, hva, bm, scale};
  const int threads = 256;
  const int blocks = (n + S + threads - 1) / threads;
  gj_fold_update_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, static_cast<const int*>(seed), static_cast<int*>(drift_bits), st, n, S, nz,
      nyb, plane, noisy, noise, k);
  return static_cast<int>(cudaGetLastError());
}

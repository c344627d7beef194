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
// The noise n comes from the Philox-4x32-10 counter hash of gj_common.cuh
// (shared with the unfused update gj_update.cu, #11): the TPU's hardware
// PRNG has no counterpart, and a counter hash lets the plain version
// (update_kernel.py:philox4x32) draw the same numbers. The seed is read
// from the device (GridState.step), so a step needs no host read for it.
// The drift is a warp max, then atomicMax on the int bits of the
// non-negative float into a zeroed int32. S more threads apply the same
// update to the straggler rows (spos, svel, sforce [S, 3], spid [S]),
// with noise counters (s, j, 1, 0), occupied where spid >= 0; the JAX
// engine does this in separate jnp ops (md2.py:190-213).
//
// What bounds it: memory, 24 grid reads (x, y, z, w, home force, 12 group
// grids, the 3 reference positions) and 6 grid writes per call.

#include "gj_common.cuh"

namespace {

struct Ins {
  // x, y, z, wx, wy, wz, hfx, hfy, hfz, 12 groups (3 + 3g + c), rx, ry, rz
  const float* p[24];
};

struct Outs {
  float* p[6];
};

__global__ void gj_fold_update_kernel(Ins in, Outs out, const int* __restrict__ seed_ptr,
                                      int* __restrict__ drift_bits, gj::Strag st, int n, int S,
                                      int nz, int nyb, int plane, int noisy, int noise,
                                      gj::Coef k) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  float dinf = 0.0f;
  if (idx >= n && idx < n + S)
    gj::strag_row(st, k, idx - n, static_cast<uint32_t>(*seed_ptr), noisy, noise);
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
    if (noisy)
      gj::normals(static_cast<uint32_t>(*seed_ptr), static_cast<uint32_t>(idx), 0u, noise,
                  k.scale, nse);
    const float m = in.p[0][idx] < 1.0e8f ? 1.0f : 0.0f;
    for (int c = 0; c < 3; ++c) {
      float f = in.p[6 + c][idx];
      for (int g = 0; g < 4; ++g) f = __fadd_rn(f, in.p[9 + 3 * g + c][src[g]]);
      float po, wo;
      gj::update(k, in.p[c][idx], in.p[3 + c][idx], f, nse[c], m, &po, &wo);
      out.p[c][idx] = po;
      out.p[3 + c][idx] = wo;
      dinf = fmaxf(dinf, fabsf(__fsub_rn(po, in.p[21 + c][idx])));
    }
    dinf = __fmul_rn(m, dinf);
  }
  gj::drift_max(dinf, drift_bits);  // every lane of the warp reaches here
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
  const gj::Strag st{static_cast<const float*>(strag_ins[0]),
                     static_cast<const float*>(strag_ins[1]),
                     static_cast<const float*>(strag_ins[2]),
                     static_cast<const int*>(strag_ins[3]), static_cast<float*>(strag_outs[0]),
                     static_cast<float*>(strag_outs[1])};
  const gj::Coef k{hv, bdt, c_x, dt, a, hva, bm, scale};
  const int threads = 256;
  const int blocks = (n + S + threads - 1) / threads;
  gj_fold_update_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, static_cast<const int*>(seed), static_cast<int*>(drift_bits), st, n, S, nz,
      nyb, plane, noisy, noise, k);
  return static_cast<int>(cudaGetLastError());
}

// Gronbech-Jensen Langevin update from folded forces, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/update_kernel.py:
// make_gj_update_kernel (pallas_call at :134; body :75-119), which the v2
// engine launches when the reaction fold is not fused into the update
// (md2.py:101-107, :228-232). Per slot, from the folded force f:
//   v  = w + hv f                      (complete the deferred half kick)
//   x' = x + m (bdt v + c_x (dt f + n))
//   w' = m ((a v + hva f) + bm n)      with m = (x < 1e8), the occupied mask
//   drift = max over slots of m * max(|x' - rx|, |y' - ry|, |z' - rz|)
// The JAX kernel draws Box-Muller normals from the TPU's hardware PRNG; here
// they come from the Philox-4x32-10 counter hash and the "bm" generator of
// gj_common.cuh, with the key (GridState.step, read on the device), slot
// counters and streams of the fused update gj_fold_update.cu (#12): a fused
// and an unfused run draw the same numbers. S more threads update the
// straggler rows as #12 does (noise stream 1), the JAX engine's
// _strag_update (md2.py:190-213), so a step launches one update.
//
// Design: one thread per slot; the drift is a warp max, then atomicMax on
// the int bits of the non-negative float into a zeroed int32.
//
// What bounds it: memory, 12 grid reads (x, y, z, w, f, the 3 reference
// positions) and 6 grid writes per call.

#include "gj_common.cuh"

namespace {

struct Ins {
  const float* p[12];  // x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz
};

struct Outs {
  float* p[6];
};

__global__ void gj_update_kernel(Ins in, Outs out, const int* __restrict__ seed_ptr,
                                 int* __restrict__ drift_bits, gj::Strag st, int n, int S,
                                 int noisy, gj::Coef k) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  float dinf = 0.0f;
  if (idx >= n && idx < n + S)
    gj::strag_row(st, k, idx - n, static_cast<uint32_t>(*seed_ptr), noisy, 1);
  if (idx < n) {
    float nse[3] = {0.0f, 0.0f, 0.0f};
    if (noisy)
      gj::normals(static_cast<uint32_t>(*seed_ptr), static_cast<uint32_t>(idx), 0u, 1, k.scale,
                  nse);
    const float m = in.p[0][idx] < 1.0e8f ? 1.0f : 0.0f;
    for (int c = 0; c < 3; ++c) {
      float po, wo;
      gj::update(k, in.p[c][idx], in.p[3 + c][idx], in.p[6 + c][idx], nse[c], m, &po, &wo);
      out.p[c][idx] = po;
      out.p[3 + c][idx] = wo;
      dinf = fmaxf(dinf, fabsf(__fsub_rn(po, in.p[9 + c][idx])));
    }
    dinf = __fmul_rn(m, dinf);
  }
  gj::drift_max(dinf, drift_bits);  // every lane of the warp reaches here
}

}  // namespace

// ins: host array of 12 device pointers, outs: of 6; seed: device int32;
// drift_bits: device int32[1], zeroed by the caller; strag_ins: spos, svel,
// sforce (float32 [S, 3]) and spid (int32 [S]); strag_outs: spos', svel';
// n = nz * nyb * CAP * NLANE.
extern "C" int uammd_gj_update(void** ins, void** outs, void* seed, void* drift_bits,
                               void** strag_ins, void** strag_outs, int n, int S, int noisy,
                               float hv, float bdt, float c_x, float dt, float a, float hva,
                               float bm, float amp, void* stream) {
  Ins in;
  for (int q = 0; q < 12; ++q) in.p[q] = static_cast<const float*>(ins[q]);
  Outs out;
  for (int q = 0; q < 6; ++q) out.p[q] = static_cast<float*>(outs[q]);
  const gj::Strag st{static_cast<const float*>(strag_ins[0]),
                     static_cast<const float*>(strag_ins[1]),
                     static_cast<const float*>(strag_ins[2]),
                     static_cast<const int*>(strag_ins[3]), static_cast<float*>(strag_outs[0]),
                     static_cast<float*>(strag_outs[1])};
  const gj::Coef k{hv, bdt, c_x, dt, a, hva, bm, amp};
  const int threads = 256;
  const int blocks = (n + S + threads - 1) / threads;
  gj_update_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, static_cast<const int*>(seed), static_cast<int*>(drift_bits), st, n, S, noisy,
      k);
  return static_cast<int>(cudaGetLastError());
}

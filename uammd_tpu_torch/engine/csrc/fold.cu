// Reaction fold of the Newton pair force, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/kernel2.py:make_fold_kernel
// (pallas_call at :531):
//     f[z, yb] = home[z, yb] + sum_g G_g[(z - dz_g) % nz, (yb - dyb_g) % nyb]
// over REACTION_GROUPS = ((1,-1), (1,0), (1,1), (0,1)), added in that order
// with __fadd_rn, so the result equals fold_reactions_jnp bit for bit.
//
// Design: one thread per slot, looping over x, y, z; the group reads are
// the same (row, lane) of a shifted (z, yb) block, so a warp reads 32
// neighbouring floats of each of the 15 grids.
//
// What bounds it: memory, 15 grid reads and 3 grid writes per call.

#include <cuda_runtime.h>

namespace {

struct Ins {
  const float* p[15];  // home x, y, z; then group g component c at 3 + 3g + c
};

struct Outs {
  float* p[3];
};

__global__ void fold_kernel(Ins in, Outs out, int nz, int nyb, int plane) {
  const size_t total = static_cast<size_t>(nz) * nyb * plane;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int rem = static_cast<int>(idx % plane);
  const int zyb = static_cast<int>(idx / plane);
  const int yb = zyb % nyb;
  const int zc = zyb / nyb;
  const int gdz[4] = {1, 1, 1, 0};
  const int gdyb[4] = {-1, 0, 1, 1};
  size_t src[4];
  for (int g = 0; g < 4; ++g) {
    const int sz = (zc - gdz[g] + nz) % nz;
    const int syb = (yb - gdyb[g] + nyb) % nyb;
    src[g] = (static_cast<size_t>(sz) * nyb + syb) * plane + rem;
  }
  for (int c = 0; c < 3; ++c) {
    float acc = in.p[c][idx];
    for (int g = 0; g < 4; ++g) acc = __fadd_rn(acc, in.p[3 + 3 * g + c][src[g]]);
    out.p[c][idx] = acc;
  }
}

}  // namespace

// ins: host array of 15 device pointers, outs: of 3; plane = CAP * NLANE.
extern "C" int uammd_fold(void** ins, void** outs, int nz, int nyb, int plane,
                          void* stream) {
  Ins in;
  for (int k = 0; k < 15; ++k) in.p[k] = static_cast<const float*>(ins[k]);
  Outs out;
  for (int k = 0; k < 3; ++k) out.p[k] = static_cast<float*>(outs[k]);
  const size_t total = static_cast<size_t>(nz) * nyb * plane;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  fold_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(in, out, nz, nyb,
                                                                         plane);
  return static_cast<int>(cudaGetLastError());
}

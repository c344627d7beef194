// Reaction fold of the Newton kernels, n channels, for Hopper (sm_90a).
//
// Replaces three TPU kernels of uammd_tpu/engine/kernel2.py:
//   make_fold_kernel      (pallas_call at :531), the 3-channel fold of the
//                         Newton pair force (entry uammd_fold),
//   make_fold_kernel_n    (pallas_call at :702), the n-channel fold of the
//                         Newton channel kernel (entry uammd_fold_n, n <= 6),
//   make_fold_kernel_halo (pallas_call at :613), the 3-channel fold on a
//                         non-periodic z-slab of parallel/domain2.py (entry
//                         uammd_fold_halo): at row 0 the dz = 1 groups read
//                         the down neighbour's 9 recv blocks [1, nyb, CAP,
//                         NLANE] (REACTION_GROUPS[:3] x (x, y, z)) at
//                         (yb - dyb) % nyb instead of row nz - 1, as
//                         fold_reactions_halo_jnp does.
// Both compute, per channel c,
//     out_c[z, yb] = home_c[z, yb] + sum_g G_{g,c}[(z - dz_g) % nz, (yb - dyb_g) % nyb]
// over REACTION_GROUPS = ((1,-1), (1,0), (1,1), (0,1)), added in that order
// with __fadd_rn, so the result equals fold_reactions_jnp /
// fold_reactions_n_jnp bit for bit.
//
// Design: one thread per slot, looping over the channels; the group reads
// are the same (row, lane) of a shifted (z, yb) block, so a warp reads 32
// neighbouring floats of each of the 5n grids.
//
// What bounds it: memory, 5n grid reads and n grid writes per call.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChan = 6;

struct Ins {
  const float* p[5 * kMaxChan];  // home c at c; group g channel c at n + g*n + c
};

struct Outs {
  float* p[kMaxChan];
};

struct Recv {
  const float* p[9];  // group g (dz = 1) channel c at 3 g + c; unused when !halo
};

__global__ void fold_kernel(Ins in, Outs out, Recv recv, int halo, int n, int nz, int nyb,
                            int plane) {
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
  bool from_recv[4];
  for (int g = 0; g < 4; ++g) {
    const int syb = (yb - gdyb[g] + nyb) % nyb;
    from_recv[g] = halo && gdz[g] == 1 && zc == 0;
    const int sz = from_recv[g] ? 0 : (zc - gdz[g] + nz) % nz;
    src[g] = (static_cast<size_t>(sz) * nyb + syb) * plane + rem;
  }
  for (int c = 0; c < n; ++c) {
    float acc = in.p[c][idx];
    for (int g = 0; g < 4; ++g) {
      const float* gp = from_recv[g] ? recv.p[3 * g + c] : in.p[n + g * n + c];
      acc = __fadd_rn(acc, gp[src[g]]);
    }
    out.p[c][idx] = acc;
  }
}

int launch(void** ins, void** outs, void** recvs, int n, int nz, int nyb, int plane,
           void* stream) {
  if (n < 1 || n > kMaxChan) return static_cast<int>(cudaErrorInvalidValue);
  Ins in;
  for (int k = 0; k < 5 * n; ++k) in.p[k] = static_cast<const float*>(ins[k]);
  Outs out;
  for (int k = 0; k < n; ++k) out.p[k] = static_cast<float*>(outs[k]);
  Recv recv{};
  if (recvs != nullptr) {
    for (int k = 0; k < 9; ++k) recv.p[k] = static_cast<const float*>(recvs[k]);
  }
  const size_t total = static_cast<size_t>(nz) * nyb * plane;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  fold_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, recv, recvs != nullptr, n, nz, nyb, plane);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ins: host array of 15 device pointers, outs: of 3; plane = CAP * NLANE.
extern "C" int uammd_fold(void** ins, void** outs, int nz, int nyb, int plane, void* stream) {
  return launch(ins, outs, nullptr, 3, nz, nyb, plane, stream);
}

// ins: host array of 5n device pointers (home, then the 4 groups, n each),
// outs: of n; 1 <= n <= 6.
extern "C" int uammd_fold_n(void** ins, void** outs, int n, int nz, int nyb, int plane,
                            void* stream) {
  return launch(ins, outs, nullptr, n, nz, nyb, plane, stream);
}

// The halo fold: ins, outs as uammd_fold; recvs: host array of 9 device
// pointers, the [1, nyb, CAP, NLANE] recv blocks.
extern "C" int uammd_fold_halo(void** ins, void** outs, void** recvs, int nz, int nyb,
                               int plane, void* stream) {
  if (recvs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ins, outs, recvs, 3, nz, nyb, plane, stream);
}

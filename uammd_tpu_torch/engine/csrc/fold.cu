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
//                         the down neighbour's 9 recv rows [9, nyb, CAP,
//                         NLANE] (REACTION_GROUPS[:3] x (x, y, z)) at
//                         (yb - dyb) % nyb instead of row nz - 1, as
//                         fold_reactions_halo_jnp does.
// All compute, per channel c,
//     out_c[z, yb] = home_c[z, yb] + sum_g G_{g,c}[(z - dz_g) % nz, (yb - dyb_g) % nyb]
// over REACTION_GROUPS = ((1,-1), (1,0), (1,1), (0,1)), added in that order
// with __fadd_rn, so the result equals fold_reactions_jnp /
// fold_reactions_n_jnp / fold_reactions_halo_jnp bit for bit.
//
// #7: one thread per slot, looping over the channels; the group reads are
// the same (row, lane) of a shifted (z, yb) block, so a warp reads 32
// neighbouring floats of each of the 15 grids. Its wrapper passes a
// pointer a grid.
//
// #9 and #8 take stacked buffers: the Newton kernels' output as it is,
// [5, n, nz, nyb, CAP, NLANE] (home channel c at c, group g channel c at
// n + n g + c; the Newton pair kernels' [15, ...] is n = 3), #8 also the
// [9, nyb, CAP, NLANE] block the reactions' exchange delivers, and one
// [n, ...] output, so a wrapper checks two or three tensors and builds no
// pointer array. What held the one-pointer-a-grid design back was the host
// (for #8, 24 tensor checks and three ctypes pointer arrays a call: on an
// H100 a 4-shard sweep took 0.44-0.55 ms against 0.114 ms of device time;
// for #9, 5n checks, two arrays and the splits of the Newton channel
// kernel's buffer into 5n views) and then the device code (one thread a
// slot, 64-bit division and modulo, 4-byte loads, the channels in turn:
// 28 us a launch against #8's 9 us byte bound). Device code (fold_rows):
// one thread per 4 slots of a plane (a 16-byte load of each of the 5n
// inputs, all in flight before the adds), a block row per (z, yb) whose
// four group source rows each thread computes once, 32-bit index math
// with no division a slot.
//
// What bounds all three: memory, 5n grid reads and n grid writes per call.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxChan = 6;

struct Ins {
  const float* p[5 * kMaxChan];  // home c at c; group g channel c at n + g*n + c
};

struct Outs {
  float* p[kMaxChan];
};

__global__ void fold_kernel(Ins in, Outs out, int n, int nz, int nyb, int plane) {
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
    const int syb = (yb - gdyb[g] + nyb) % nyb;
    const int sz = (zc - gdz[g] + nz) % nz;
    src[g] = (static_cast<size_t>(sz) * nyb + syb) * plane + rem;
  }
  for (int c = 0; c < n; ++c) {
    float acc = in.p[c][idx];
    for (int g = 0; g < 4; ++g) acc = __fadd_rn(acc, in.p[n + g * n + c][src[g]]);
    out.p[c][idx] = acc;
  }
}

int launch(void** ins, void** outs, int n, int nz, int nyb, int plane, void* stream) {
  if (n < 1 || n > kMaxChan) return static_cast<int>(cudaErrorInvalidValue);
  Ins in;
  for (int k = 0; k < 5 * n; ++k) in.p[k] = static_cast<const float*>(ins[k]);
  Outs out;
  for (int k = 0; k < n; ++k) out.p[k] = static_cast<float*>(outs[k]);
  const size_t total = static_cast<size_t>(nz) * nyb * plane;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  fold_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(in, out, n, nz, nyb,
                                                                          plane);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

constexpr int kRowThreads = 256;

// Blocks (plane4 / 256 rounded up, nz nyb); thread q of block row zyb owns
// slots 4 q .. 4 q + 3 of the plane of (z, yb). in: [5 N, grid4] float4s
// (home c at c, group g channel c at N + N g + c); grid4 = nz nyb plane4,
// a channel's float4s. HALO: z is a slab, and row 0's dz = 1 groups read
// recv [3 N, nyb, plane4] (N = 3) instead of row nz - 1.
template <int N, bool HALO>
__global__ void __launch_bounds__(kRowThreads)
    fold_rows(const float4* __restrict__ in, const float4* __restrict__ recv,
              float4* __restrict__ out, int nz, int nyb, int plane4, int grid4) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= plane4) return;
  const int zyb = blockIdx.y;
  const int zc = zyb / nyb;  // once a thread
  const int yb = zyb - zc * nyb;
  const int yb_up = yb + 1 == nyb ? 0 : yb + 1;  // yb - dyb for dyb = -1
  const int yb_dn = yb == 0 ? nyb - 1 : yb - 1;  // for dyb = 1
  const int z_dn = (zc == 0 ? nz : zc) - 1;      // z - dz for dz = 1, periodic
  const int sybs[4] = {yb_up, yb, yb_dn, yb_dn};
  // the (1, dyb) groups: row z - 1 (or in the halo mode at z = 0 the recv
  // rows); (0, 1): row z
  const float4* gsrc[4];
  int gstride[4];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    if (HALO && zc == 0) {
      gsrc[g] = recv + (N * g * nyb + sybs[g]) * plane4 + q;
      gstride[g] = nyb * plane4;
    } else {
      gsrc[g] = in + (N + N * g) * grid4 + (z_dn * nyb + sybs[g]) * plane4 + q;
      gstride[g] = grid4;
    }
  }
  gsrc[3] = in + 4 * N * grid4 + (zyb - yb + sybs[3]) * plane4 + q;
  gstride[3] = grid4;
  const int at = zyb * plane4 + q;
  float4 h[N], v[4][N];
#pragma unroll
  for (int c = 0; c < N; ++c) h[c] = in[c * grid4 + at];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int c = 0; c < N; ++c) v[g][c] = gsrc[g][c * gstride[g]];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    float4 acc = h[c];
#pragma unroll
    for (int g = 0; g < 4; ++g) acc = add4(acc, v[g][c]);
    out[c * grid4 + at] = acc;
  }
}

// the stacked entries' shared checks: plane a multiple of 4, 16-byte
// aligned buffers, 32-bit float4 indices, a block row per (z, yb)
bool rows_ok(const void* a, const void* b, const void* c, int n, int nz, int nyb, int plane) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(c);
  const size_t floats = 5 * static_cast<size_t>(n) * nz * nyb * plane;
  return nz >= 1 && nyb >= 1 && plane >= 4 && plane % 4 == 0 && (align & 15) == 0 &&
         floats < (static_cast<size_t>(1) << 31) && nz * nyb <= 65535;
}

template <int N, bool HALO>
int launch_rows(const void* in, const void* recv, void* out, int nz, int nyb, int plane,
                void* stream) {
  const int plane4 = plane / 4;
  const dim3 grid((plane4 + kRowThreads - 1) / kRowThreads, nz * nyb);
  fold_rows<N, HALO><<<grid, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(in), static_cast<const float4*>(recv),
      static_cast<float4*>(out), nz, nyb, plane4, nz * nyb * plane4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ins: host array of 15 device pointers, outs: of 3; plane = CAP * NLANE.
extern "C" int uammd_fold(void** ins, void** outs, int nz, int nyb, int plane, void* stream) {
  return launch(ins, outs, 3, nz, nyb, plane, stream);
}

// The n-channel fold on the Newton channel kernel's buffer: raw: [5, n, nz,
// nyb, plane] (home, then the 4 groups, n channels each), out: [n, nz, nyb,
// plane]; 1 <= n <= 6; plane = CAP * NLANE, a multiple of 4; 16-byte
// aligned pointers.
extern "C" int uammd_fold_n(void* raw, void* out, int n, int nz, int nyb, int plane,
                            void* stream) {
  if (n < 1 || n > kMaxChan || !rows_ok(raw, out, out, n, nz, nyb, plane))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    case 1: return launch_rows<1, false>(raw, nullptr, out, nz, nyb, plane, stream);
    case 2: return launch_rows<2, false>(raw, nullptr, out, nz, nyb, plane, stream);
    case 3: return launch_rows<3, false>(raw, nullptr, out, nz, nyb, plane, stream);
    case 4: return launch_rows<4, false>(raw, nullptr, out, nz, nyb, plane, stream);
    case 5: return launch_rows<5, false>(raw, nullptr, out, nz, nyb, plane, stream);
    default: return launch_rows<6, false>(raw, nullptr, out, nz, nyb, plane, stream);
  }
}

// The halo fold: in: [15, nz, nyb, plane] (the Newton halo kernel's
// output), recv: [9, nyb, plane], out: [3, nz, nyb, plane]; plane = CAP *
// NLANE, a multiple of 4; 16-byte aligned pointers.
extern "C" int uammd_fold_halo(void* in, void* recv, void* out, int nz, int nyb, int plane,
                               void* stream) {
  if (!rows_ok(in, recv, out, 3, nz, nyb, plane)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows<3, true>(in, recv, out, nz, nyb, plane, stream);
}

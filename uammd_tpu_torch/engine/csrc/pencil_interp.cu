// Pencil interpolation (IBM J = S*: grid -> particles) for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/solvers/pencil_ibm.py:
// interpolate_pencil_fused (pallas_call at :572), with the haloed window
// that XLA builds for it there:
//     out[slot, c] = sum over nodes of field[gx, gy, gz, c] phi(dx) phi(dy) phi(dz)
// for the particle in each occupied slot of each xy-pencil, over the nodes
// of that pencil's patch (P = 8 + 2 halo nodes per axis, wrapped mod nx,
// ny) and the z nodes where phi is nonzero. out is [npen * cap, C]; the
// caller gathers it by slot_of_pid. Empty slots are left as they are (the
// caller zeroes out; the TPU kernel fills them from particle 0's
// coordinates, and no caller reads them).
//
// Design: one block per pencil, one warp per occupied slot, the same
// weights, ballot ranges and walk as pencil_spread.cu (pencil_common.cuh).
// The warp walks the particle's (x, y) columns with its lanes over
// (column, z), reads the C channels of each node straight from the field
// ([C, nx, ny, nz], channel first: neighbouring lanes read neighbouring z
// nodes) at wrapped indices (no [npen, P^2, nz C] window, 6.1 GB at
// 384^3), keeps C sums per lane in registers and reduces them across the
// warp with shuffles. z visits only the support window, as in the spread.
//
// What bounds it: the N * support^3 * C field reads and their multiply-adds
// (2.2e9 operations on the 131072-particle, 384^3, support-14 path); the
// bytes the function must move (the field once, 680 MB) are the bound the
// card could reach, since neighbouring particles read the same nodes.

#include "pencil_common.cuh"

namespace {

using namespace pencil;

template <int C>
__global__ void __launch_bounds__(WARPS * 32)
    interp_kernel(const float* __restrict__ u, const float* __restrict__ field,
                  const int* __restrict__ pids, float* __restrict__ out, Phi k, Geo g, int cap) {
  __shared__ float sw[WARPS][3][32];
  const int pen = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wx = sw[warp][0];
  float* wy = sw[warp][1];
  float* wz = sw[warp][2];
  const size_t plane = static_cast<size_t>(g.nx) * g.ny * g.nz;
  for (int slot = warp; slot < cap; slot += WARPS) {
    const int pid = pids[static_cast<size_t>(pen) * cap + slot];
    if (pid <= 0) continue;  // warp-uniform
    const size_t i = static_cast<size_t>(pid - 1);
    const Win w = weights(k, g, pen, u[3 * i], u[3 * i + 1], u[3 * i + 2], lane, wx, wy, wz);
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    walk(g, w, wx, wy, wz, lane, [&](size_t node, float wv) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += wv * field[c * plane + node];
    });
#pragma unroll
    for (int c = 0; c < C; ++c) {
      for (int off = 16; off > 0; off >>= 1) acc[c] += __shfl_xor_sync(FULL, acc[c], off);
    }
    if (lane == 0) {
      float* dst = out + (static_cast<size_t>(pen) * cap + slot) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) dst[c] = acc[c];
    }
    __syncwarp();
  }
}

}  // namespace

// u: [N, 3] node coordinates, field: [C, nx, ny, nz], pids: [npen, cap]
// 1-based ids (0 = empty), out: [npen * cap, C]. kind, a, b: the window
// function (see Phi). Returns cudaGetLastError().
extern "C" int uammd_pencil_interp(void* u, void* field, void* pids, void* out, int nx, int ny,
                                   int nz, int npy, int halo, int support, int cap, int npen,
                                   int C, int kind, float a, float b, void* stream) {
  Phi k;
  Geo g;
  if (!make_geo(&k, &g, nx, ny, nz, npy, halo, support, npen, kind, a, b))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_channels(C, [&](auto c) {
    interp_kernel<decltype(c)::value><<<npen, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u), static_cast<const float*>(field),
        static_cast<const int*>(pids), static_cast<float*>(out), k, g, cap);
  });
}

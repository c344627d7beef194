// Pencil spread (IBM S: particles -> grid) for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/solvers/pencil_ibm.py:spread_pencil_fused
// (pallas_call at :450), with the overlap-add fold and the 1/dV scale that
// run outside it there:
//     field[gx, gy, gz, c] += scale * v[i, c] * phi(dx) phi(dy) phi(dz)
// for every particle i binned in an xy-pencil, over the nodes of that
// pencil's patch (P = 8 + 2 halo nodes per axis, wrapped mod nx, ny) and
// the z nodes where phi is nonzero. The field is stored channel first,
// [C, nx, ny, nz] (the layout torch.fft takes without a copy), and must be
// zero on entry.
//
// Design: one block per pencil, one warp per occupied slot. The lanes
// compute the particle's x- and y-weights at the P patch nodes (lane =
// patch node, the TPU's min-image rule) and its z-weights at support + 1
// nodes around uz, and a ballot gives the nonzero range of each
// (pencil_common.cuh, shared with pencil_interp.cu). The warp then walks
// the (x, y) columns of that range with its lanes over (column, z) and
// adds each product with atomicAdd: neighbouring lanes add to neighbouring
// z nodes of one channel. The TPU's [npen, P^2, nz C] patch
// (6.1 GB at 384^3) and its fold never exist, and z visits only the support
// window: the TPU evaluates phi at all nz nodes, but phi is zero outside
// |r| < support/2, so this is the same function.
//
// What bounds it: the float atomics, N * support^3 * C of them (1.1e9 on
// the 131072-particle, 384^3, support-14 path), far above its bytes.

#include "pencil_common.cuh"

namespace {

using namespace pencil;

template <int C>
__global__ void __launch_bounds__(WARPS * 32)
    spread_kernel(const float* __restrict__ u, const float* __restrict__ vals,
                  const int* __restrict__ pids, float* __restrict__ field, Phi k, Geo g, int cap,
                  float scale) {
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
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = vals[i * C + c] * scale;
    walk(g, w, wx, wy, wz, lane, [&](size_t node, float wv) {
#pragma unroll
      for (int c = 0; c < C; ++c) atomicAdd(field + c * plane + node, wv * v[c]);
    });
    __syncwarp();
  }
}

}  // namespace

// u: [N, 3] node coordinates, vals: [N, C], pids: [npen, cap] 1-based ids
// (0 = empty), field: [C, nx, ny, nz] zeroed. kind, a, b: the window
// function (see Phi). Returns cudaGetLastError().
extern "C" int uammd_pencil_spread(void* u, void* vals, void* pids, void* field, int nx, int ny,
                                   int nz, int npy, int halo, int support, int cap, int npen,
                                   int C, int kind, float a, float b, float scale, void* stream) {
  Phi k;
  Geo g;
  if (!make_geo(&k, &g, nx, ny, nz, npy, halo, support, npen, kind, a, b))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_channels(C, [&](auto c) {
    spread_kernel<decltype(c)::value><<<npen, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u), static_cast<const float*>(vals),
        static_cast<const int*>(pids), static_cast<float*>(field), k, g, cap, scale);
  });
}

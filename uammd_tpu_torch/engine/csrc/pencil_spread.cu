// Pencil spread (IBM S: particles -> grid) for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/solvers/pencil_ibm.py:spread_pencil_fused
// (pallas_call at :450), with the overlap-add fold and the 1/dV scale that
// run outside it there:
//     field[gx, gy, gz, c] = sum over particles i of
//                            scale * v[i, c] * phi(dx) phi(dy) phi(dz)
// for every particle i binned in an xy-pencil, over the nodes of that
// pencil's patch (P = 8 + 2 halo nodes per axis, wrapped mod nx, ny) and
// the z nodes where phi is nonzero. The field is stored channel first,
// [C, nx, ny, nz] (the layout torch.fft takes without a copy); every node is
// written, so it need not be zeroed.
//
// Design: owner-computed tiles (pencil_common.cuh). A block owns one
// pencil's 8 x 8 columns times TZ z nodes times C channels and gathers the
// candidates whose patch and z window meet it, with their weights in shared
// memory. Each thread owns the 8 columns of one x row at one z node and sums,
// candidate after candidate in slot order, wx wy wz * v[c] into 8 x C
// registers; it then stores each sum once (z fastest, coalesced). There is
// no atomic, and the order of the sums is fixed, so two calls give the same
// bits. The TPU's [npen, P^2, nz C] patch (6.1 GB at 384^3) and its fold
// never exist, and z takes only the support window.
//
// What bounds it: on an H100 the gathering of the candidates and their
// weights takes about half of the time (dependent loads and the block's
// barriers, latency more than issue), the tile product the rest: dense
// over the tile, ~1e10 multiply-adds on the 131072-particle, 384^3,
// support-14 path (a candidate's z window covers about a third of a
// 32-node tile). Its bytes (the field written once, 680 MB) take about
// 0.2 ms.

#include "pencil_common.cuh"

namespace {

using namespace pencil;

// The registers a thread may take: the fewest at which ptxas (CUDA 12.8,
// sm_90a) spills nothing in the instance, so that as many blocks as can
// share an SM do.
constexpr int spread_regs(int C) { return C <= 2 ? 48 : C == 3 ? 64 : C <= 6 ? 80 : 128; }

template <int C, int TZ>
__global__ void __launch_bounds__(threads_of(TZ), min_blocks(TZ, spread_regs(C)))
    spread_kernel(const float* __restrict__ u, const float* __restrict__ vals,
                  const int* __restrict__ pids, const int* __restrict__ nbr,
                  float* __restrict__ field, Phi k, Geo g, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int tz = threadIdx.x % TZ, jx = threadIdx.x / TZ;  // the thread's x row and z node
  const int pen = blockIdx.y, zlo = blockIdx.x * TZ;
  float* sv = tile_extra<TZ>(smem, g.chunk);  // [chunk][C]
  float acc[PENCIL][C];
#pragma unroll
  for (int j = 0; j < PENCIL; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.0f;
  }
  tile_loop<TZ>(
      k, g, u, pids, nbr, pen, zlo, smem,
      [&](int s, int pid) {
        const size_t i = static_cast<size_t>(pid - 1);
#pragma unroll
        for (int c = 0; c < C; ++c) sv[s * C + c] = vals[i * C + c] * scale;
      },
      [&](const Chunk& ch, const float4*, int, int) {
        for (int s = 0; s < ch.n; ++s) {
          if (!ch.live[s]) continue;  // block-uniform
          if (__all_sync(FULL, ch.wx[s * 8 + jx] == 0.0f)) continue;  // the warp's rows
          const float wzv = ch.wz[s * TZ + tz];
          const float4 a = *reinterpret_cast<const float4*>(ch.wxy + s * 64 + jx * 8);
          const float4 b = *reinterpret_cast<const float4*>(ch.wxy + s * 64 + jx * 8 + 4);
          const float wxy[PENCIL] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
          float v[C];
#pragma unroll
          for (int c = 0; c < C; ++c) v[c] = sv[s * C + c];
#pragma unroll
          for (int j = 0; j < PENCIL; ++j) {
            const float w = wxy[j] * wzv;
#pragma unroll
            for (int c = 0; c < C; ++c) acc[j][c] += w * v[c];
          }
        }
      });
  if (tz < g.nz - zlo) {
    const size_t plane = static_cast<size_t>(g.nx) * g.ny * g.nz;
    const int px = pen / g.npy, py = pen - px * g.npy;
    const size_t col0 =
        (static_cast<size_t>(px * PENCIL + jx) * g.ny + py * PENCIL) * g.nz + zlo + tz;
#pragma unroll
    for (int j = 0; j < PENCIL; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) field[c * plane + col0 + static_cast<size_t>(j) * g.nz] = acc[j][c];
    }
  }
}

}  // namespace

// The dynamic shared memory of a spread block (pencil_ibm.pencil_smem_bytes).
extern "C" int uammd_pencil_spread_smem(int C, int tz) {
  return static_cast<int>(smem_bytes(C, tz, chunk_of(tz), false));
}

// u: [N, 3] node coordinates, vals: [N, C], pids: [npen, cap] 1-based ids
// (0 = empty), nbr: [npen, 9] the pencils whose patch covers each pencil's
// columns (-1 padded), field: [C, nx, ny, nz], every node written. kind, a,
// b: the window function (see Phi); tz: the launch plan's tile height
// (pencil_ibm.pencil_launch_plan). Returns the launch's CUDA error.
extern "C" int uammd_pencil_spread(void* u, void* vals, void* pids, void* nbr, void* field,
                                   int nx, int ny, int nz, int npy, int halo, int support,
                                   int cap, int npen, int C, int kind, int tz, float a,
                                   float b, float scale, void* stream) {
  Phi k;
  Geo g;
  if (!make_geo(&k, &g, nx, ny, nz, npy, halo, support, cap, npen, kind, a, b, tz, C,
                false))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(C, tz, chunk_of(tz), false);
  return by_shape(C, tz, [&](auto c, auto z) {
    constexpr int CC = decltype(c)::value, TZ = decltype(z)::value;
    const dim3 grid((nz + TZ - 1) / TZ, npen);
    spread_kernel<CC, TZ><<<grid, threads_of(TZ), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u), static_cast<const float*>(vals),
        static_cast<const int*>(pids), static_cast<const int*>(nbr), static_cast<float*>(field),
        k, g, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

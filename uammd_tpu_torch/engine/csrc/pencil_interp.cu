// Pencil interpolation (IBM J = S*: grid -> particles) for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/solvers/pencil_ibm.py:
// interpolate_pencil_fused (pallas_call at :572), with the haloed window
// that XLA builds for it there:
//     out[slot, c] = sum over nodes of field[gx, gy, gz, c] phi(dx) phi(dy) phi(dz)
// for the particle in each occupied slot of each xy-pencil, over the nodes
// of that pencil's patch (P = 8 + 2 halo nodes per axis, wrapped mod nx,
// ny) and the z nodes where phi is nonzero. out is [npen * cap, C] and must
// be zero on entry; the caller gathers it by slot_of_pid. Empty slots stay
// 0 (the TPU kernel fills them from particle 0's coordinates, and no caller
// reads them).
//
// Design: the adjoint of pencil_spread.cu on the same tiles, candidates and
// weights (pencil_common.cuh). A block reads its tile of the field
// ([C, nx, ny, nz], channel first) once, coalesced, into registers: each
// thread holds the 8 columns of its x row at one z node, C channels each,
// so the field crosses device memory about once. For each candidate, each
// thread sums wx wy wz * f over its nodes; the warp reduces the C sums with
// a butterfly that halves the channels it carries at each of the first
// log2(C) steps (6 shuffles for C = 3 or 4, not 5 C); the block adds its
// warps' partials in a fixed order and each candidate adds its C values to
// its slot with one atomicAdd per channel. A particle meets 3 x 3 column
// tiles times 1 or 2 z tiles, so the 131072-particle, 384^3, support-14 path
// makes ~1e7 atomics where a walk over each particle's nodes reads the
// field 1.1e9 times.
//
// What bounds it: as in the spread, the gathering of the candidates and
// their weights, then the tile product (~1e10 multiply-adds on that path)
// and here the warp reductions; the field's bytes, read once (680 MB),
// take about 0.2 ms.

#include "pencil_common.cuh"

namespace {

using namespace pencil;

// The sums over the warp of a[0 .. V): returns the sum of a[idx], and idx,
// for the lane's idx (every lane whose low 5 - log2(V) bits are 0 holds a
// distinct idx). The first log2(V) steps trade half of the values still
// carried with the partner lane, the rest add the one value left.
template <int V>
__device__ __forceinline__ float warp_sums(float (&a)[V], int lane, int* idx) {
  int off = 16;
  *idx = 0;
#pragma unroll
  for (int h = V / 2; h >= 1; h /= 2) {
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? a[i] : a[i + h];
      const float keep = up ? a[i + h] : a[i];
      a[i] = keep + __shfl_xor_sync(FULL, send, off);
    }
    *idx += up ? h : 0;
    off /= 2;
  }
#pragma unroll
  for (; off >= 1; off /= 2) a[0] += __shfl_xor_sync(FULL, a[0], off);
  return a[0];
}

// The registers a thread may take: the fewest at which ptxas (CUDA 12.8,
// sm_90a) spills nothing in the instance, so that as many blocks as can
// share an SM do.
constexpr int interp_regs(int C, int tz) {
  return C <= 2 ? 48 : C == 3 || (C == 4 && tz == 16) ? 64 : C <= 5 || (C == 6 && tz == 32) ? 80 : 128;
}

template <int C, int TZ>
__global__ void __launch_bounds__(threads_of(TZ), min_blocks(TZ, interp_regs(C, TZ)))
    interp_kernel(const float* __restrict__ u, const float* __restrict__ field,
                  const int* __restrict__ pids, const int* __restrict__ nbr,
                  float* __restrict__ out, Phi k, Geo g) {
  extern __shared__ __align__(16) char smem[];
  constexpr int V = C <= 1 ? 1 : C <= 2 ? 2 : C <= 4 ? 4 : 8;
  constexpr int T = threads_of(TZ), WARPS = T / 32;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tz = t % TZ, jx = t / TZ;  // the thread's x row and z node
  const int pen = blockIdx.y, zlo = blockIdx.x * TZ;
  float* part = tile_extra<TZ>(smem, g.chunk);  // [WARPS][chunk][C]
  // the thread's nodes of the field tile
  float f[PENCIL][C];
  {
    const bool in = tz < g.nz - zlo;
    const size_t plane = static_cast<size_t>(g.nx) * g.ny * g.nz;
    const int px = pen / g.npy, py = pen - px * g.npy;
    const size_t col0 =
        (static_cast<size_t>(px * PENCIL + jx) * g.ny + py * PENCIL) * g.nz + zlo + tz;
#pragma unroll
    for (int j = 0; j < PENCIL; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        f[j][c] = in ? field[c * plane + col0 + static_cast<size_t>(j) * g.nz] : 0.0f;
    }
  }
  tile_loop<TZ>(
      k, g, u, pids, nbr, pen, zlo, smem, [](int, int) {},
      [&](const Chunk& ch, const float4* list, int start, int ring) {
        for (int s = 0; s < ch.n; ++s) {
          if (!ch.live[s]) continue;  // block-uniform
          float* dst = part + (static_cast<size_t>(warp) * g.chunk + s) * C;
          if (__all_sync(FULL, ch.wx[s * 8 + jx] == 0.0f)) {  // the warp's rows
            if (lane < C) dst[lane] = 0.0f;
            continue;
          }
          const float wzv = ch.wz[s * TZ + tz];
          const float4 a4 = *reinterpret_cast<const float4*>(ch.wxy + s * 64 + jx * 8);
          const float4 b4 = *reinterpret_cast<const float4*>(ch.wxy + s * 64 + jx * 8 + 4);
          const float wxy[PENCIL] = {a4.x, a4.y, a4.z, a4.w, b4.x, b4.y, b4.z, b4.w};
          float a[V];
#pragma unroll
          for (int c = 0; c < V; ++c) a[c] = 0.0f;
#pragma unroll
          for (int j = 0; j < PENCIL; ++j) {
            const float w = wxy[j] * wzv;
#pragma unroll
            for (int c = 0; c < C; ++c) a[c] += w * f[j][c];
          }
          int idx;
          const float tot = warp_sums<V>(a, lane, &idx);
          if ((lane & (32 / V - 1)) == 0 && idx < C) dst[idx] = tot;
        }
        __syncthreads();
        for (int it = t; it < ch.n * C; it += T) {
          const int s = it / C, c = it - s * C;
          if (!ch.live[s]) continue;
          float sum = 0.0f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) sum += part[(static_cast<size_t>(w) * g.chunk + s) * C + c];
          if (sum != 0.0f) {
            const int flat = __float_as_int(list[(start + s) % ring].w);
            atomicAdd(out + static_cast<size_t>(flat) * C + c, sum);
          }
        }
      });
}

}  // namespace

// The dynamic shared memory of an interpolation block
// (pencil_ibm.pencil_smem_bytes).
extern "C" int uammd_pencil_interp_smem(int C, int tz) {
  return static_cast<int>(smem_bytes(C, tz, chunk_of(tz), true));
}

// u: [N, 3] node coordinates, field: [C, nx, ny, nz], pids: [npen, cap]
// 1-based ids (0 = empty), nbr: [npen, 9] the pencils whose patch covers
// each pencil's columns (-1 padded), out: [npen * cap, C] zeroed. kind, a,
// b: the window function (see Phi); tz: the launch plan's tile height
// (pencil_ibm.pencil_launch_plan). Returns the launch's CUDA error.
extern "C" int uammd_pencil_interp(void* u, void* field, void* pids, void* nbr, void* out,
                                   int nx, int ny, int nz, int npy, int halo, int support,
                                   int cap, int npen, int C, int kind, int tz, float a,
                                   float b, void* stream) {
  Phi k;
  Geo g;
  if (!make_geo(&k, &g, nx, ny, nz, npy, halo, support, cap, npen, kind, a, b, tz, C,
                true))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(C, tz, chunk_of(tz), true);
  return by_shape(C, tz, [&](auto c, auto z) {
    constexpr int CC = decltype(c)::value, TZ = decltype(z)::value;
    const dim3 grid((nz + TZ - 1) / TZ, npen);
    interp_kernel<CC, TZ><<<grid, threads_of(TZ), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u), static_cast<const float*>(field),
        static_cast<const int*>(pids), static_cast<const int*>(nbr), static_cast<float*>(out), k,
        g);
    return static_cast<int>(cudaGetLastError());
  });
}

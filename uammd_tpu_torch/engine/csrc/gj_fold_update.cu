// Fused reaction fold + Gronbech-Jensen Langevin update, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/update_kernel.py:
// make_gj_fold_update_kernel (pallas_call at :301), with its noise
// generators _clt_normals (:156) and _bm_normals (:184). Per slot:
//   f  = home + sum_g G_g[(z - dz_g) % nz, (yb - dyb_g) % nyb]  (fold.cu's order)
//   v  = w + hv f                      (complete the deferred half kick)
//   x' = x + m (bdt v + c_x (dt f + n))
//   w' = m ((a v + hva f) + bm n)      with m = (x < 1e8), the occupied mask
//   drift = max over slots of where(m, max(|x' - rx|, |y' - ry|, |z' - rz|), 0)
// (JAX's select rule, NaN kept: gj_common.cuh)
// The noise n comes from the Philox-4x32-10 counter hash of gj_common.cuh
// (shared with the unfused update gj_update.cu, #11): the TPU's hardware
// PRNG has no counterpart, and a counter hash lets the plain version
// (update_kernel.py:philox4x32) draw the same numbers. The seed is read
// from the device (GridState.step), so a step needs no host read for it.
// One more row of blocks applies the same update to the straggler rows
// (spos, svel, sforce [S, 3], spid [S]), with noise counters (s, j, 1, 0),
// occupied where spid >= 0; the JAX engine does this in separate jnp ops
// (md2.py:190-213).
//
// The forces come as the Newton pair kernel's output as it is, [15, nz,
// nyb, CAP, NLANE] (home x, y, z, then group g channel c at 3 + 3 g + c),
// and the outputs go to one buffer: x', y', z', w'x, w'y, w'z [6, ...], the
// stragglers' spos', svel' [2, S, 3], the drift. What held the design with
// a pointer a grid back (0.132 ms a call on an H100 against a 0.062 ms byte
// bound): the host (24 tensor checks, four ctypes pointer arrays and a
// zero-fill launch for the drift a call) and the device code (a thread a
// slot with 12 integer divisions or modulos, 24 scalar 4-byte loads, and
// one same-address atomicMax a warp: 53,760 a step at v2's [42, 10, 32,
// 128]).
//
// Design: a block row per (z, yb) plane, whose four group source rows each
// thread computes once (no division a slot); a thread owns 4 slots and
// reads each input as a 16-byte load, channel by channel (8 loads in
// flight a channel: position, w, home force, 4 groups, reference). The
// drift is reduced in the block and over the blocks by a ticket
// (gj::drift_reduce, shared with #11), so no buffer is zeroed a call.
//
// What bounds it: memory, 24 grid reads (x, y, z, w, the 15 force grids,
// the 3 reference positions) and 6 grid writes per call.

#include "gj_common.cuh"

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Grids {
  const float4* p[3];  // x, y, z
  const float4* w[3];
  const float4* r[3];  // the reference positions
};

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_comp(float4& v, int j, float x) {
  if (j == 0) v.x = x;
  else if (j == 1) v.y = x;
  else if (j == 2) v.z = x;
  else v.w = x;
}

// NOISE: -1 none (T = 0), 0 "clt", 1 "bm". Blocks (plane4 / 256 rounded
// up, nz nyb + 1); block row zyb < nz nyb: thread q owns slots 4 q .. 4 q +
// 3 of that plane; the last row: thread q the straggler row q < S.
template <int NOISE>
__global__ void __launch_bounds__(kThreads)
    gj_fold_update_rows(Grids in, const float4* __restrict__ f, float4* __restrict__ out,
                        const int* __restrict__ seed_ptr, int* __restrict__ partial,
                        unsigned* __restrict__ ticket, int* __restrict__ drift_bits,
                        gj::Strag st, int S, int nz, int nyb, int plane4, gj::Coef k) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int zyb = blockIdx.y;
  const int nzyb = nz * nyb;
  const int grid4 = nzyb * plane4;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  int dbits = 0;  // this thread's drift bits (gj::abs_bits)
  if (zyb == nzyb) {
    if (q < S) gj::strag_row(st, k, q, seed, NOISE >= 0, NOISE < 0 ? 0 : NOISE);
  } else if (q < plane4) {
    const int zc = zyb / nyb;  // once a thread
    const int yb = zyb - zc * nyb;
    const int yb_up = yb + 1 == nyb ? 0 : yb + 1;  // yb - dyb for dyb = -1
    const int yb_dn = yb == 0 ? nyb - 1 : yb - 1;  // for dyb = 1
    const int z_dn = (zc == 0 ? nz : zc) - 1;      // z - dz for dz = 1
    const int src[4] = {(z_dn * nyb + yb_up) * plane4 + q, (z_dn * nyb + yb) * plane4 + q,
                        (z_dn * nyb + yb_dn) * plane4 + q, (zyb - yb + yb_dn) * plane4 + q};
    const int at = zyb * plane4 + q;
    const float4 x4 = in.p[0][at];
    float m[4], nse[4][3];
    int dj[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = comp(x4, j) < 1.0e8f ? 1.0f : 0.0f;
      if (NOISE >= 0) {
        gj::normals(seed, static_cast<uint32_t>(4 * at + j), 0u, NOISE, k.scale, nse[j]);
      } else {
        nse[j][0] = nse[j][1] = nse[j][2] = 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 p = c == 0 ? x4 : in.p[c][at];
      const float4 w = in.w[c][at];
      float4 acc = f[c * grid4 + at];
      float4 g[4];
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) g[gi] = f[(3 + 3 * gi + c) * grid4 + src[gi]];
      const float4 r = in.r[c][at];
      float4 po, wo;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float fj = comp(acc, j);
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) fj = __fadd_rn(fj, comp(g[gi], j));
        float pj, wj;
        gj::update(k, comp(p, j), comp(w, j), fj, nse[j][c], m[j], &pj, &wj);
        set_comp(po, j, pj);
        set_comp(wo, j, wj);
        dj[j] = max(dj[j], gj::abs_bits(__fsub_rn(pj, comp(r, j))));
      }
      out[c * grid4 + at] = po;
      out[(3 + c) * grid4 + at] = wo;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) dbits = max(dbits, m[j] != 0.0f ? dj[j] : 0);
  }
  gj::drift_reduce<kThreads>(dbits, partial, ticket, drift_bits);
}

template <int NOISE>
void launch(const Grids& in, const void* f, void* out, const void* seed, int* partial,
            unsigned* ticket, int* drift, const gj::Strag& st, int S, int nz, int nyb,
            int plane4, const gj::Coef& k, dim3 grid, cudaStream_t stream) {
  gj_fold_update_rows<NOISE><<<grid, kThreads, 0, stream>>>(
      in, static_cast<const float4*>(f), static_cast<float4*>(out),
      static_cast<const int*>(seed), partial, ticket, drift, st, S, nz, nyb, plane4, k);
}

dim3 grid_of(int nz, int nyb, int plane, int S) {
  const int plane4 = plane / 4;
  const int bx = (plane4 > S ? plane4 : S) + kThreads - 1;
  return dim3(bx / kThreads, nz * nyb + 1);
}

}  // namespace

// The int32 scratch a launch needs: a block's drift maximum each, then the
// ticket counter; zeroed once by the caller, kept across calls (the last
// block resets the ticket).
extern "C" long long uammd_gj_fold_update_scratch(int nz, int nyb, int plane, int S) {
  const dim3 g = grid_of(nz, nyb, plane, S);
  return static_cast<long long>(g.x) * g.y + 1;
}

// The launch's geometry, for checks that need a slot's block: dims = the
// blocks along a plane (grid.x), the block rows (grid.y: nz nyb planes, then
// the straggler rows), a block's threads and a thread's slots; block
// (row, col) updates slots [4 kThreads col, 4 kThreads (col + 1)) of plane row.
extern "C" void uammd_gj_fold_update_grid(int nz, int nyb, int plane, int S, int* dims) {
  const dim3 g = grid_of(nz, nyb, plane, S);
  dims[0] = static_cast<int>(g.x);
  dims[1] = static_cast<int>(g.y);
  dims[2] = kThreads;
  dims[3] = 4;
}

// x, y, z, wx, wy, wz, rx, ry, rz: device grids [nz, nyb, plane]; forces:
// [15, nz, nyb, plane] (home x, y, z, then group g channel c at 3 + 3 g +
// c); out: float32 [6 nz nyb plane + 6 S + 1]: x', y', z', w'x, w'y, w'z,
// then spos', svel' [2, S, 3], then the drift; seed: device int32; scratch:
// int32 [scratch_len] (uammd_gj_fold_update_scratch); spos, svel, sforce:
// float32 [S, 3], spid: int32 [S] (null when S = 0); plane = CAP * NLANE, a
// multiple of 4; the grids, forces and out 16-byte aligned. noisy 0: T = 0
// (no noise); noise 0 "clt" (scale = amp sqrt(3) / 65536), 1 "bm" (scale =
// amp).
extern "C" int uammd_gj_fold_update(void* x, void* y, void* z, void* wx, void* wy, void* wz,
                                    void* forces, void* rx, void* ry, void* rz, void* out,
                                    void* seed, void* scratch, long long scratch_len,
                                    void* spos, void* svel, void* sforce, void* spid, int S,
                                    int nz, int nyb, int plane, int noisy, int noise, float hv,
                                    float bdt, float c_x, float dt, float a, float hva,
                                    float bm, float scale, void* stream) {
  const void* grids[11] = {x, y, z, wx, wy, wz, rx, ry, rz, forces, out};
  uintptr_t align = 0;
  for (const void* g : grids) align |= reinterpret_cast<uintptr_t>(g);
  const size_t T = static_cast<size_t>(nz) * nyb * plane;
  if (nz < 1 || nyb < 1 || plane < 4 || plane % 4 != 0 || (align & 15) != 0 || S < 0 ||
      15 * T >= (static_cast<size_t>(1) << 31) || nz * nyb + 1 > 65535 ||
      scratch_len < uammd_gj_fold_update_scratch(nz, nyb, plane, S) || noise < 0 || noise > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* o = static_cast<float*>(out);
  Grids in;
  const void* ps[3] = {x, y, z};
  const void* ws[3] = {wx, wy, wz};
  const void* rs[3] = {rx, ry, rz};
  for (int c = 0; c < 3; ++c) {
    in.p[c] = static_cast<const float4*>(ps[c]);
    in.w[c] = static_cast<const float4*>(ws[c]);
    in.r[c] = static_cast<const float4*>(rs[c]);
  }
  const gj::Strag st{static_cast<const float*>(spos), static_cast<const float*>(svel),
                     static_cast<const float*>(sforce), static_cast<const int*>(spid),
                     o + 6 * T, o + 6 * T + 3 * static_cast<size_t>(S)};
  const gj::Coef k{hv, bdt, c_x, dt, a, hva, bm, scale};
  int* partial = static_cast<int*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(partial + scratch_len - 1);
  int* drift = reinterpret_cast<int*>(o + 6 * T + 6 * static_cast<size_t>(S));
  const dim3 grid = grid_of(nz, nyb, plane, S);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int plane4 = plane / 4;
  if (!noisy)
    launch<-1>(in, forces, out, seed, partial, ticket, drift, st, S, nz, nyb, plane4, k, grid, s);
  else if (noise == 0)
    launch<0>(in, forces, out, seed, partial, ticket, drift, st, S, nz, nyb, plane4, k, grid, s);
  else
    launch<1>(in, forces, out, seed, partial, ticket, drift, st, S, nz, nyb, plane4, k, grid, s);
  return static_cast<int>(cudaGetLastError());
}

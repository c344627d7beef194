// Gronbech-Jensen Langevin update from folded forces, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/update_kernel.py:
// make_gj_update_kernel (pallas_call at :134; body :75-119), which the v2
// engine launches when the reaction fold is not fused into the update
// (md2.py:101-107, :228-232), and the DD2 step launches on every shard
// (uammd_tpu/parallel/domain2.py:397-413). Per slot, from the folded force f:
//   v  = w + hv f                      (complete the deferred half kick)
//   x' = x + m (bdt v + c_x (dt f + n))
//   w' = m ((a v + hva f) + bm n)      with m = (x < 1e8), the occupied mask
//   drift = max over slots of where(m, max(|x' - rx|, |y' - ry|, |z' - rz|), 0)
// (JAX's select rule, NaN kept: gj_common.cuh). The JAX kernel draws
// Box-Muller normals from the TPU's hardware PRNG; here they come from the
// Philox-4x32-10 counter hash and the "bm" generator of gj_common.cuh, with
// the key (GridState.step, read on the device), slot counters and streams
// of the fused update gj_fold_update.cu (#12): a fused and an unfused run
// draw the same numbers. One more row of blocks updates the S straggler
// rows as #12 does (noise stream 1; the JAX engine's _strag_update,
// md2.py:190-213), so a step launches one update. Given the rows'
// reference positions (sref), their drift where(occupied, |spos' - sref|,
// 0) joins the same maximum, as JAX's DD2 step takes it
// (domain2.py:409-413); the rows' ids come as pid (int32, -1 empty) or as
// the DD2 state's pid + 1 (float32, occupied where > 0.5).
//
// What held the design this replaces (a thread a slot, 4-byte loads,
// pointer arrays; 0.228 ms a call on the unfused v2 path and 0.850 ms a
// 4-shard DD2 sweep on an H100, against 0.037 and 0.035 ms byte bounds):
// the host (12 tensor checks, three ctypes pointer arrays and a zero-fill
// launch for the drift a call, and on DD2 five or so torch launches a shard
// for the straggler rows' drift) and one same-address atomicMax a warp.
//
// Design, #12's (gj_fold_update.cu): a block row per (z, yb) plane and one
// for the straggler rows; a thread owns 4 slots and issues its 12 input
// loads (x, y, z, w, f, the reference positions) as 16-byte loads before
// any arithmetic; the outputs go to one buffer (x', y', z', w'x, w'y, w'z,
// spos', svel', the drift). The drift is reduced in the block and over the
// blocks by a ticket (gj::drift_reduce), so no buffer is zeroed a call.
//
// What bounds it: memory, 12 grid reads and 6 grid writes per call.

#include "gj_common.cuh"

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Grids {
  const float4* p[3];  // x, y, z
  const float4* w[3];
  const float4* f[3];  // the folded forces
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

// NOISE: -1 none (T = 0), 1 "bm". Blocks (plane4 / 256 rounded up, nz nyb
// + 1); block row zyb < nz nyb: thread q owns slots 4 q .. 4 q + 3 of that
// plane; the last row: thread q the straggler row q < S.
template <int NOISE>
__global__ void __launch_bounds__(kThreads)
    gj_update_rows(Grids in, float4* __restrict__ out, const int* __restrict__ seed_ptr,
                   int* __restrict__ partial, unsigned* __restrict__ ticket,
                   int* __restrict__ drift_bits, gj::Strag st, int S, int nzyb, int plane4,
                   gj::Coef k) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int zyb = blockIdx.y;
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  int dbits = 0;  // this thread's drift bits (gj::abs_bits)
  if (zyb == nzyb) {
    if (q < S) dbits = gj::strag_row(st, k, q, seed, NOISE >= 0, 1);
  } else if (q < plane4) {
    const int at = zyb * plane4 + q;
    const int grid4 = nzyb * plane4;
    float4 p[3], w[3], f[3], r[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {  // all 12 loads in flight before any arithmetic
      p[c] = in.p[c][at];
      w[c] = in.w[c][at];
      f[c] = in.f[c][at];
      r[c] = in.r[c][at];
    }
    float m[4], nse[4][3];
    int dj[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = comp(p[0], j) < 1.0e8f ? 1.0f : 0.0f;
      if (NOISE >= 0) {
        gj::normals(seed, static_cast<uint32_t>(4 * at + j), 0u, 1, k.scale, nse[j]);
      } else {
        nse[j][0] = nse[j][1] = nse[j][2] = 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float4 po, wo;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pj, wj;
        gj::update(k, comp(p[c], j), comp(w[c], j), comp(f[c], j), nse[j][c], m[j], &pj, &wj);
        set_comp(po, j, pj);
        set_comp(wo, j, wj);
        dj[j] = max(dj[j], gj::abs_bits(__fsub_rn(pj, comp(r[c], j))));
      }
      out[c * grid4 + at] = po;
      out[(3 + c) * grid4 + at] = wo;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) dbits = max(dbits, m[j] != 0.0f ? dj[j] : 0);
  }
  gj::drift_reduce<kThreads>(dbits, partial, ticket, drift_bits);
}

dim3 grid_of(int nz, int nyb, int plane, int S) {
  const int plane4 = plane / 4;
  const int bx = (plane4 > S ? plane4 : S) + kThreads - 1;
  return dim3(bx / kThreads, nz * nyb + 1);
}

// The launch's scalar arguments, which a caller keeps for its spec and
// coefficients and passes by address.
struct Params {
  int nz, nyb, plane, noisy;
  float hv, bdt, c_x, dt, a, hva, bm, amp;
};

}  // namespace

// The int32 scratch a launch needs: a block's drift maximum each, then the
// ticket counter; zeroed once by the caller, kept across calls (the last
// block resets the ticket).
extern "C" long long uammd_gj_update_scratch(int nz, int nyb, int plane, int S) {
  const dim3 g = grid_of(nz, nyb, plane, S);
  return static_cast<long long>(g.x) * g.y + 1;
}

// The launch's geometry, for checks that need a slot's block: dims = the
// blocks along a plane (grid.x), the block rows (grid.y: nz nyb planes, then
// the straggler rows), a block's threads and a thread's slots.
extern "C" void uammd_gj_update_grid(int nz, int nyb, int plane, int S, int* dims) {
  const dim3 g = grid_of(nz, nyb, plane, S);
  dims[0] = static_cast<int>(g.x);
  dims[1] = static_cast<int>(g.y);
  dims[2] = kThreads;
  dims[3] = 4;
}

// The size of the Params block that uammd_gj_update reads: nz, nyb, plane
// (CAP * NLANE, a multiple of 4) and noisy (0: T = 0) as int32, then hv,
// bdt, c_x, dt, a, hva, bm and amp as float32.
extern "C" int uammd_gj_update_params_size() { return static_cast<int>(sizeof(Params)); }

// x .. rz: device grids [nz, nyb, plane], 16-byte aligned; out: float32 [6
// nz nyb plane + 6 S + 1], 16-byte aligned: x', y', z', w'x, w'y, w'z, then
// spos', svel' [2, S, 3], then the drift; seed: device int32; scratch:
// int32 [scratch_len] (uammd_gj_update_scratch); spos, svel, sforce:
// float32 [S, 3]; spid: int32 [S] (pid, -1 empty) or, with spid_float,
// float32 [S] (pid + 1, 0 empty); sref: float32 [S, 3] or null (then the
// rows add nothing to the drift); all null when S = 0; params: a host
// Params block (uammd_gj_update_params_size).
extern "C" int uammd_gj_update(void* x, void* y, void* z, void* wx, void* wy, void* wz,
                               void* fx, void* fy, void* fz, void* rx, void* ry, void* rz,
                               void* out, void* seed, void* scratch, long long scratch_len,
                               void* spos, void* svel, void* sforce, void* spid,
                               int spid_float, void* sref, int S, const void* params,
                               void* stream) {
  const Params& pa = *static_cast<const Params*>(params);
  const void* grids[13] = {x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz, out};
  uintptr_t align = 0;
  for (const void* g : grids) align |= reinterpret_cast<uintptr_t>(g);
  const size_t T = static_cast<size_t>(pa.nz) * pa.nyb * pa.plane;
  if (pa.nz < 1 || pa.nyb < 1 || pa.plane < 4 || pa.plane % 4 != 0 || (align & 15) != 0 ||
      S < 0 || 6 * T >= (static_cast<size_t>(1) << 31) || pa.nz * pa.nyb + 1 > 65535 ||
      scratch_len < uammd_gj_update_scratch(pa.nz, pa.nyb, pa.plane, S) ||
      (S > 0 && (spos == nullptr || svel == nullptr || sforce == nullptr || spid == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* o = static_cast<float*>(out);
  Grids in;
  void* const ps[12] = {x, y, z, wx, wy, wz, fx, fy, fz, rx, ry, rz};
  for (int c = 0; c < 3; ++c) {
    in.p[c] = static_cast<const float4*>(ps[c]);
    in.w[c] = static_cast<const float4*>(ps[3 + c]);
    in.f[c] = static_cast<const float4*>(ps[6 + c]);
    in.r[c] = static_cast<const float4*>(ps[9 + c]);
  }
  gj::Strag st{static_cast<const float*>(spos), static_cast<const float*>(svel),
               static_cast<const float*>(sforce),
               spid_float ? nullptr : static_cast<const int*>(spid), o + 6 * T,
               o + 6 * T + 3 * static_cast<size_t>(S)};
  st.pidf = spid_float ? static_cast<const float*>(spid) : nullptr;
  st.ref = static_cast<const float*>(sref);
  const gj::Coef k{pa.hv, pa.bdt, pa.c_x, pa.dt, pa.a, pa.hva, pa.bm, pa.amp};
  int* partial = static_cast<int*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(partial + scratch_len - 1);
  int* drift = reinterpret_cast<int*>(o + 6 * T + 6 * static_cast<size_t>(S));
  const dim3 grid = grid_of(pa.nz, pa.nyb, pa.plane, S);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int plane4 = pa.plane / 4;
  float4* o4 = static_cast<float4*>(out);
  const int* sp = static_cast<const int*>(seed);
  if (pa.noisy)
    gj_update_rows<1><<<grid, kThreads, 0, s>>>(in, o4, sp, partial, ticket, drift, st, S,
                                                 pa.nz * pa.nyb, plane4, k);
  else
    gj_update_rows<-1><<<grid, kThreads, 0, s>>>(in, o4, sp, partial, ticket, drift, st, S,
                                                  pa.nz * pa.nyb, plane4, k);
  return static_cast<int>(cudaGetLastError());
}

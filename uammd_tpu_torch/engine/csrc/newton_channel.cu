// Newton-halved channel transverser with the PSE near-field functor, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/kernel2.py:make_newton_channel_kernel
// (pallas_call at :992) with pair_both_fn = the PSE near-field RPY remainder
// (pse_engine.py:_pair_fn, device form in pse_near.cuh), NV = 1 or 2
// stacked 3-vectors (3 or 6 channels in and out). Each unordered pair of
// cells is visited once:
//   - the home cell: every ordered pair, forward only (as the JAX kernel);
//   - the 13 positive offsets POS_OFFSETS: forward onto the home slot, and
//     the reverse contribution onto the candidate's own slot (its row and
//     lane) of home when the candidate lies in the home (z, y-block), else
//     of reaction group G_g, g the candidate block's displacement in
//     REACTION_GROUPS = ((1,-1), (1,0), (1,1), (0,1)), stored at the HOME
//     block index: the fold (fold.cu, uammd_fold_n) adds G_g[z - dz, yb - dyb];
//   - the straggler list ([3 + 3 NV + 1, S]: x, y, z, channels, valid), a
//     candidate of every home slot, each direction's displacement rounded
//     as for a grid candidate of an image cell (pse::image_pair):
//     forward onto the home slot, reverse reduced straight into
//     spart [3 NV, S] (the JAX kernel returns per-program partials that its
//     caller sums over (z, yb, lane)).
// raw = [5, 3 NV, T] (home, then the groups in REACTION_GROUPS order) and
// spart are zeroed by the caller.
//
// Design: one thread per home slot; a block owns `rows` home rows of one
// (z, yb) across all NLANE lanes (blockDim = (NLANE, rows)). For dz = 0 and
// then dz = 1 it stages kJ candidate rows of the three y-blocks yb-1, yb,
// yb+1 of slab z+dz (coordinates and channels) in shared memory, and every
// thread walks its offsets over the staged rows. The forward sums stay in
// registers; reverse contributions go out with float atomicAdd, only for
// pairs inside rcut (about 14 % of the candidate slots at the PSE grid), so
// their order, and the last bits of the sums, change from run to run. kJ is
// the largest count (<= 8) whose staging plus the straggler list fits 48 KB.
//
// What bounds it: operations. Per home slot (1 + 13) * CAP candidate slots
// of ~10 float32 instructions for the cutoff test, and for pairs inside rcut
// the radial (two 12-step Horner chains, rsqrt) and 12 NV multiply-adds each
// way; it moves 3 + 3 NV input and 15 NV output grids. Registers (ptxas -v
// with CUDA 12.8 for sm_90a): 48 at NV = 1, 56 at NV = 2, no spills.

#include "pse_near.cuh"

namespace {

template <int NV>
__global__ void newton_channel_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                      const float* __restrict__ z,
                                      const float* __restrict__ ch,
                                      const float* __restrict__ strag, float* __restrict__ raw,
                                      float* __restrict__ spart, pse::Geom g, pse::Near p,
                                      int S, int kJ) {
  constexpr int NC = 3 * NV;
  constexpr int NA = 3 + NC;  // staged arrays: x, y, z, channels
  extern __shared__ float smem[];  // [3 y-blocks][NA][kJ][nlane], then [NA + 1][S]
  const int nlane = g.nlane;
  const int arr_stride = kJ * nlane;
  float* sstrag = smem + 3 * NA * arr_stride;
  const int lane = threadIdx.x;
  const int c = blockIdx.x * blockDim.y + threadIdx.y;
  const int yb = blockIdx.y;
  const int zc = blockIdx.z;
  const bool home = c < g.cap;
  const int cx = lane / g.F;
  const int f = lane - cx * g.F;
  const int ny = g.nyb * g.F;
  const int cy = yb * g.F + f;
  const size_t plane = static_cast<size_t>(g.cap) * nlane;
  const size_t T = static_cast<size_t>(g.nz) * g.nyb * plane;
  const size_t blk = (static_cast<size_t>(zc) * g.nyb + yb) * plane;  // home block
  const size_t hidx = blk + static_cast<size_t>(c) * nlane + lane;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int e = tid; e < (NA + 1) * S; e += nthreads) sstrag[e] = strag[e];

  float xi = 0.0f, yi = 0.0f, zi = 0.0f;
  float Fi[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) Fi[k] = 0.0f;
  if (home) {
    xi = x[hidx];
    yi = y[hidx];
    zi = z[hidx];
#pragma unroll
    for (int k = 0; k < NC; ++k) Fi[k] = ch[k * T + hidx];
  }
  // An empty home slot (at EMPTY_POS) has every candidate outside rcut or
  // at d = 0: all its terms are 0, so its thread only helps to stage.
  const bool active = home && xi < pse::kEmptyLimit;
  float acc[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) acc[k] = 0.0f;

  for (int dz = 0; dz <= 1; ++dz) {
    float shz = 0.0f;
    int sz = zc + dz;
    if (sz >= g.nz) { sz -= g.nz; shz = g.Lz; }
    for (int j0 = 0; j0 < g.cap; j0 += kJ) {
      const int nj = min(kJ, g.cap - j0);
      const int per_block = nj * nlane;
      __syncthreads();  // the previous pass is done reading
      for (int e = tid; e < 3 * per_block; e += nthreads) {
        const int b = e / per_block;
        const int r = e - b * per_block;  // jj * nlane + l
        int syb = yb + b - 1;
        syb = syb < 0 ? syb + g.nyb : (syb >= g.nyb ? syb - g.nyb : syb);
        const size_t src = (static_cast<size_t>(sz) * g.nyb + syb) * plane +
                           static_cast<size_t>(j0) * nlane + r;
        float* dst = smem + b * NA * arr_stride + r;
        dst[0] = x[src];
        dst[arr_stride] = y[src];
        dst[2 * arr_stride] = z[src];
#pragma unroll
        for (int k = 0; k < NC; ++k) dst[(3 + k) * arr_stride] = ch[k * T + src];
      }
      __syncthreads();
      if (!active) continue;

      if (dz == 0) {
        // the home cell (staged y-block 1, own lane): forward only
        const float* s = smem + NA * arr_stride + lane;
        for (int jj = 0; jj < nj; ++jj) {
          const int o = jj * nlane;
          const float dxv = s[o] - xi;
          const float dyv = s[arr_stride + o] - yi;
          const float dzv = s[2 * arr_stride + o] - zi;
          float fr, gr;
          if (!pse::radial(pse::dist2(dxv, dyv, dzv), p, &fr, &gr)) continue;
          float Fj[NC];
#pragma unroll
          for (int k = 0; k < NC; ++k) Fj[k] = s[(3 + k) * arr_stride + o];
          pse::apply<NV>(fr, gr, dxv, dyv, dzv, Fj, acc);
        }
      }
      // positive offsets of this dz (dz = 1: every dy; dz = 0: dy = 1, and
      // dy = 0 with dx = 1 only)
      for (int dy = (dz == 1 ? -1 : 0); dy <= 1; ++dy) {
        float shy;
        const int sy = pse::wrap_index(cy + dy, ny, g.Ly, &shy);
        const int sf = sy % g.F;
        const int b = (f + dy < 0) ? 0 : ((f + dy >= g.F) ? 2 : 1);
        // the grid of the reverse contribution: home, or group (dz, b - 1)
        const int target = dz == 0 ? (b == 1 ? 0 : 4) : 1 + b;
        float* out = raw + static_cast<size_t>(target) * NC * T;
        for (int dx = (dz == 0 && dy == 0 ? 1 : -1); dx <= 1; ++dx) {
          float shx;
          const int sx = pse::wrap_index(cx + dx, g.nx, g.Lx, &shx);
          const int sl = sx * g.F + sf;
          const float* s = smem + b * NA * arr_stride + sl;
          for (int jj = 0; jj < nj; ++jj) {
            const int o = jj * nlane;
            const float dxv = __fadd_rn(s[o], shx) - xi;
            const float dyv = __fadd_rn(s[arr_stride + o], shy) - yi;
            const float dzv = __fadd_rn(s[2 * arr_stride + o], shz) - zi;
            float fr, gr;
            if (!pse::radial(pse::dist2(dxv, dyv, dzv), p, &fr, &gr)) continue;
            float Fj[NC];
#pragma unroll
            for (int k = 0; k < NC; ++k) Fj[k] = s[(3 + k) * arr_stride + o];
            pse::apply<NV>(fr, gr, dxv, dyv, dzv, Fj, acc);
            float rev[NC];
#pragma unroll
            for (int k = 0; k < NC; ++k) rev[k] = 0.0f;
            pse::apply<NV>(fr, gr, dxv, dyv, dzv, Fi, rev);
            const size_t d = blk + static_cast<size_t>(j0 + jj) * nlane + sl;
#pragma unroll
            for (int k = 0; k < NC; ++k) atomicAdd(out + k * T + d, rev[k]);
          }
        }
      }
    }
  }

  if (!active) return;
  for (int s = 0; s < S; ++s) {
    if (!(sstrag[(NA) * S + s] > 0.5f)) continue;
    float d[3], e[3];  // onto the home slot, onto the row
    pse::image_pair(sstrag[s], xi, g.Lx, g.iLx, &d[0], &e[0]);
    pse::image_pair(sstrag[S + s], yi, g.Ly, g.iLy, &d[1], &e[1]);
    pse::image_pair(sstrag[2 * S + s], zi, g.Lz, g.iLz, &d[2], &e[2]);
    float fr, gr;
    if (pse::radial(pse::dist2(d[0], d[1], d[2]), p, &fr, &gr)) {
      float Fj[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) Fj[k] = sstrag[(3 + k) * S + s];
      pse::apply<NV>(fr, gr, d[0], d[1], d[2], Fj, acc);
    }
    if (!pse::radial(pse::dist2(e[0], e[1], e[2]), p, &fr, &gr)) continue;
    float rev[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) rev[k] = 0.0f;
    pse::apply<NV>(fr, gr, e[0], e[1], e[2], Fi, rev);
#pragma unroll
    for (int k = 0; k < NC; ++k) atomicAdd(spart + k * S + s, rev[k]);
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) atomicAdd(raw + k * T + hidx, acc[k]);
}

template <int NV>
int launch(const float* x, const float* y, const float* z, const float* ch, const float* strag,
           float* raw, float* spart, const pse::Geom& g, const pse::Near& p, int S, int rows,
           int kJ, cudaStream_t st) {
  const dim3 block(g.nlane, rows);
  const dim3 grid((g.cap + rows - 1) / rows, g.nyb, g.nz);
  const size_t smem = sizeof(float) * (3 * (3 + 3 * NV) * kJ * g.nlane + (4 + 3 * NV) * S);
  newton_channel_kernel<NV><<<grid, block, smem, st>>>(x, y, z, ch, strag, raw, spart, g, p, S,
                                                        kJ);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ch: float32 [3 nv, T]; strag: float32 [3 + 3 nv + 1, S] or null when
// S == 0; raw: [5, 3 nv, T] and spart: [3 nv, S], both zeroed.
extern "C" int uammd_newton_channel(void* x, void* y, void* z, void* ch, void* strag, void* raw,
                                    void* spart, int nv, int nx, int nyb, int nz, int F, int cap,
                                    int S, int rows, int kJ, float Lx, float Ly, float Lz,
                                    float iLx, float iLy, float iLz, pse::Near p, void* stream) {
  const pse::Geom g{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, iLx, iLy, iLz};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(x);
  const float* fy = static_cast<const float*>(y);
  const float* fz = static_cast<const float*>(z);
  const float* fc = static_cast<const float*>(ch);
  const float* fs = static_cast<const float*>(strag);
  float* fr = static_cast<float*>(raw);
  float* fp = static_cast<float*>(spart);
  if (nv == 1) return launch<1>(fx, fy, fz, fc, fs, fr, fp, g, p, S, rows, kJ, st);
  if (nv == 2) return launch<2>(fx, fy, fz, fc, fs, fr, fp, g, p, S, rows, kJ, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

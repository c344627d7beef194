// 27-stencil channel transverser over a pair functor, for Hopper (sm_90a).
//
// Replaces the TPU kernel uammd_tpu/engine/pair_kernel.py:make_pair_channel_kernel
// (pallas_call at :538): n_chan channels in, n_out sums out, periodic in z
// (or, through the _halo entries, the z-slab halo mode: no Lz shift),
// with the pair_fn chosen at compile time as a functor of
// channel_functors.cuh (PSE near field at 1 or 2 stacked 3-vectors, DPD,
// SPH density and force, LJ mixture and its masked form, the Poisson near
// field). Every home slot
// sums the functor's contributions over the CAP slots of the 27 cells
// around it (its own cell included: each functor's r2 > eps test drops the
// self pair). With a functor that serves stragglers (kStrag: PSE, Poisson)
// the straggler list ([3 + NG + 1, S]: x, y, z, channels, valid; each
// direction's displacement rounded as for a grid candidate of an image
// cell, pse::image_pair) adds its forward contributions, and the rows' reverse
// contributions are reduced straight into spart [NOUT, S] (the JAX kernel
// returns per-program partials that its caller sums over (z, yb, lane)).
// The other functors run on straggler-free specs (n_strag = 0), as the JAX
// engines build them.
//
// Design: as newton_channel.cu, one thread per home slot, blocks of `rows`
// home rows x NLANE lanes staging kJ candidate rows (3 + NG arrays) of the
// three y-blocks of slab z+dz for dz = -1, 0, 1 in shared memory; each home
// slot keeps its channels and NOUT sums in registers and writes once. Empty
// home slots (at EMPTY_POS) skip the pair loop and write 0, as every
// functor gives them.
//
// What bounds it: operations, 27 * CAP candidate slots per home slot, the
// functor's body only for the pairs inside its cutoff. Registers and
// spills of each instantiation: ptxas -v, printed by chip_smoke.py.

#include "channel_functors.cuh"

namespace {

template <class Fn>
__global__ void pair_channel_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                    const float* __restrict__ z, const float* __restrict__ ch,
                                    const float* __restrict__ uni,
                                    const float* __restrict__ strag, float* __restrict__ out,
                                    float* __restrict__ spart, pse::Geom g, Fn fn, int S,
                                    int kJ, int periodic_z) {
  constexpr int NG = Fn::NG;
  constexpr int NA = 3 + NG;
  constexpr int NO = Fn::NOUT;
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
  const size_t hidx = (static_cast<size_t>(zc) * g.nyb + yb) * plane +
                      static_cast<size_t>(c) * nlane + lane;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  if (Fn::kStrag) {
    for (int e = tid; e < (NA + 1) * S; e += nthreads) sstrag[e] = strag[e];
  }

  float xi = 0.0f, yi = 0.0f, zi = 0.0f;
  float ci[NG + Fn::NU];
#pragma unroll
  for (int k = 0; k < NG + Fn::NU; ++k) ci[k] = 0.0f;
  if (home) {
    xi = x[hidx];
    yi = y[hidx];
    zi = z[hidx];
#pragma unroll
    for (int k = 0; k < NG; ++k) ci[k] = ch[k * T + hidx];
#pragma unroll
    for (int k = 0; k < Fn::NU; ++k) ci[NG + k] = uni[k];
  }
  const bool active = home && xi < pse::kEmptyLimit;
  float acc[NO];
#pragma unroll
  for (int k = 0; k < NO; ++k) acc[k] = 0.0f;

  for (int dz = -1; dz <= 1; ++dz) {
    float shz;
    const int sz = pse::wrap_index(zc + dz, g.nz, g.Lz, &shz);
    if (!periodic_z) shz = 0.0f;
    for (int j0 = 0; j0 < g.cap; j0 += kJ) {
      const int nj = min(kJ, g.cap - j0);
      const int per_block = nj * nlane;
      __syncthreads();
      for (int e = tid; e < 3 * per_block; e += nthreads) {
        const int b = e / per_block;
        const int r = e - b * per_block;
        int syb = yb + b - 1;
        syb = syb < 0 ? syb + g.nyb : (syb >= g.nyb ? syb - g.nyb : syb);
        const size_t src = (static_cast<size_t>(sz) * g.nyb + syb) * plane +
                           static_cast<size_t>(j0) * nlane + r;
        float* dst = smem + b * NA * arr_stride + r;
        dst[0] = x[src];
        dst[arr_stride] = y[src];
        dst[2 * arr_stride] = z[src];
#pragma unroll
        for (int k = 0; k < NG; ++k) dst[(3 + k) * arr_stride] = ch[k * T + src];
      }
      __syncthreads();
      if (!active) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        float shy;
        const int sy = pse::wrap_index(cy + dy, ny, g.Ly, &shy);
        const int sf = sy % g.F;
        const int b = (f + dy < 0) ? 0 : ((f + dy >= g.F) ? 2 : 1);
        for (int dx = -1; dx <= 1; ++dx) {
          float shx;
          const int sx = pse::wrap_index(cx + dx, g.nx, g.Lx, &shx);
          const float* s = smem + b * NA * arr_stride + sx * g.F + sf;
          for (int jj = 0; jj < nj; ++jj) {
            const int o = jj * nlane;
            const float dxv = __fadd_rn(s[o], shx) - xi;
            const float dyv = __fadd_rn(s[arr_stride + o], shy) - yi;
            const float dzv = __fadd_rn(s[2 * arr_stride + o], shz) - zi;
            fn.fwd(pse::dist2(dxv, dyv, dzv), dxv, dyv, dzv, ci, s + 3 * arr_stride + o,
                   arr_stride, acc);
          }
        }
      }
    }
  }

  if constexpr (Fn::kStrag) {
    if (active) {
      for (int s = 0; s < S; ++s) {
        if (!(sstrag[NA * S + s] > 0.5f)) continue;
        float d[3], e[3];  // onto the home slot, onto the row
        pse::image_pair(sstrag[s], xi, g.Lx, g.iLx, &d[0], &e[0]);
        pse::image_pair(sstrag[S + s], yi, g.Ly, g.iLy, &d[1], &e[1]);
        pse::image_pair(sstrag[2 * S + s], zi, g.Lz, g.iLz, &d[2], &e[2]);
        float Fj[NG];
#pragma unroll
        for (int k = 0; k < NG; ++k) Fj[k] = sstrag[(3 + k) * S + s];
        fn.fwd(pse::dist2(d[0], d[1], d[2]), d[0], d[1], d[2], ci, Fj, 1, acc);
        float rev[NO];
#pragma unroll
        for (int k = 0; k < NO; ++k) rev[k] = 0.0f;
        fn.fwd(pse::dist2(e[0], e[1], e[2]), e[0], e[1], e[2], Fj, ci, 1, rev);
        bool any = false;
#pragma unroll
        for (int k = 0; k < NO; ++k) any |= rev[k] != 0.0f;
        if (!any) continue;  // outside the cutoff: no atomics
#pragma unroll
        for (int k = 0; k < NO; ++k) atomicAdd(spart + k * S + s, rev[k]);
      }
    }
  }
  if (home) {
#pragma unroll
    for (int k = 0; k < NO; ++k) out[k * T + hidx] = acc[k];
  }
}

template <class Fn>
int launch(const float* x, const float* y, const float* z, const float* ch, const float* uni,
           const float* strag, float* out, float* spart, const pse::Geom& g, const Fn& fn,
           int S, int rows, int kJ, cudaStream_t st, int periodic_z = 1) {
  const dim3 block(g.nlane, rows);
  const dim3 grid((g.cap + rows - 1) / rows, g.nyb, g.nz);
  const size_t smem =
      sizeof(float) * (3 * (3 + Fn::NG) * kJ * g.nlane + (Fn::kStrag ? (4 + Fn::NG) * S : 0));
  pair_channel_kernel<Fn><<<grid, block, smem, st>>>(x, y, z, ch, uni, strag, out, spart, g, fn,
                                                      S, kJ, periodic_z);
  return static_cast<int>(cudaGetLastError());
}

pse::Geom geom(int nx, int nyb, int nz, int F, int cap, float Lx, float Ly, float Lz, float iLx,
               float iLy, float iLz) {
  return pse::Geom{nx, nyb, nz, F, cap, nx * F, Lx, Ly, Lz, iLx, iLy, iLz};
}

template <class Fn>
int launch_plain(void* x, void* y, void* z, void* ch, void* uni, void* out, int nx, int nyb,
                 int nz, int F, int cap, int rows, int kJ, float Lx, float Ly, float Lz,
                 const Fn& fn, void* stream, int periodic_z) {
  return launch<Fn>(static_cast<const float*>(x), static_cast<const float*>(y),
                    static_cast<const float*>(z), static_cast<const float*>(ch),
                    static_cast<const float*>(uni), nullptr, static_cast<float*>(out), nullptr,
                    geom(nx, nyb, nz, F, cap, Lx, Ly, Lz, 0.0f, 0.0f, 0.0f), fn, 0, rows, kJ,
                    static_cast<cudaStream_t>(stream), periodic_z);
}

}  // namespace

// PSE near field. ch: float32 [3 nv, T]; strag: float32 [3 + 3 nv + 1, S]
// or null when S == 0; out: [3 nv, T]; spart: [3 nv, S], zeroed.
extern "C" int uammd_pair_channel(void* x, void* y, void* z, void* ch, void* strag, void* out,
                                  void* spart, int nv, int nx, int nyb, int nz, int F, int cap,
                                  int S, int rows, int kJ, float Lx, float Ly, float Lz,
                                  float iLx, float iLy, float iLz, pse::Near p, void* stream) {
  const pse::Geom g = geom(nx, nyb, nz, F, cap, Lx, Ly, Lz, iLx, iLy, iLz);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(x);
  const float* fy = static_cast<const float*>(y);
  const float* fz = static_cast<const float*>(z);
  const float* fc = static_cast<const float*>(ch);
  const float* fs = static_cast<const float*>(strag);
  float* fo = static_cast<float*>(out);
  float* fp = static_cast<float*>(spart);
  if (nv == 1)
    return launch(fx, fy, fz, fc, nullptr, fs, fo, fp, g, chan::PSEFn<1>{p}, S, rows, kJ, st);
  if (nv == 2)
    return launch(fx, fy, fz, fc, nullptr, fs, fo, fp, g, chan::PSEFn<2>{p}, S, rows, kJ, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The straggler-free functors: ch float32 [NG, T] (the grid channels),
// uni float32 [NU] on the card (the uniform channels) or null, out [NOUT, T].
// Each has a twin NAME_halo, the z-slab halo mode of parallel/domain.py
// (pair_kernel.py:300, periodic_z=False): the z index wraps but takes no Lz
// shift; the caller passes a slab extended by image-shifted ghost rows and
// drops their outputs.
#define UAMMD_PAIR_CHANNEL_ENTRY(NAME, FN, PARAMS)                                             \
  extern "C" int NAME(void* x, void* y, void* z, void* ch, void* uni, void* out, int nx,       \
                      int nyb, int nz, int F, int cap, int rows, int kJ, float Lx, float Ly,    \
                      float Lz, PARAMS p, void* stream) {                                      \
    return launch_plain(x, y, z, ch, uni, out, nx, nyb, nz, F, cap, rows, kJ, Lx, Ly, Lz,      \
                        FN{p}, stream, 1);                                                     \
  }                                                                                            \
  extern "C" int NAME##_halo(void* x, void* y, void* z, void* ch, void* uni, void* out,        \
                             int nx, int nyb, int nz, int F, int cap, int rows, int kJ,         \
                             float Lx, float Ly, float Lz, PARAMS p, void* stream) {            \
    return launch_plain(x, y, z, ch, uni, out, nx, nyb, nz, F, cap, rows, kJ, Lx, Ly, Lz,      \
                        FN{p}, stream, 0);                                                     \
  }

UAMMD_PAIR_CHANNEL_ENTRY(uammd_pair_channel_dpd, chan::DPDFn, chan::DPDParams)
UAMMD_PAIR_CHANNEL_ENTRY(uammd_pair_channel_sph_density, chan::SPHDensityFn, chan::SPHParams)
UAMMD_PAIR_CHANNEL_ENTRY(uammd_pair_channel_sph_force, chan::SPHForceFn, chan::SPHParams)
UAMMD_PAIR_CHANNEL_ENTRY(uammd_pair_channel_lj_mix, chan::LJMixFn<false>, chan::LJMixParams)
UAMMD_PAIR_CHANNEL_ENTRY(uammd_pair_channel_lj_mix_masked, chan::LJMixFn<true>,
                         chan::LJMixParams)

// The Poisson near field, with the straggler rows: ch float32 [1, T] (the
// charges); strag float32 [5, S] (x, y, z, charge, valid) or null when
// S == 0; out [4, T]; spart [4, S], zeroed.
extern "C" int uammd_pair_channel_poisson(void* x, void* y, void* z, void* ch, void* strag,
                                          void* out, void* spart, int nx, int nyb, int nz,
                                          int F, int cap, int S, int rows, int kJ, float Lx,
                                          float Ly, float Lz, float iLx, float iLy, float iLz,
                                          chan::PoissonParams p, void* stream) {
  return launch(static_cast<const float*>(x), static_cast<const float*>(y),
                static_cast<const float*>(z), static_cast<const float*>(ch), nullptr,
                static_cast<const float*>(strag), static_cast<float*>(out),
                static_cast<float*>(spart), geom(nx, nyb, nz, F, cap, Lx, Ly, Lz, iLx, iLy, iLz),
                chan::PoissonFn{p}, S, rows, kJ, static_cast<cudaStream_t>(stream));
}

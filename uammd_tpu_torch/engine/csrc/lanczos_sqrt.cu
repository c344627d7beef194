// sqrt(T) e1 of the Lanczos tridiagonal, for Hopper (sm_90a), in one block.
//
// Replaces what uammd_tpu/solvers/lanczos.py:74-75 computes with
// jnp.linalg.eigh (no pallas_call there): for the symmetric tridiagonal
// T = tridiag(alphas[:m], betas[1:m]) it returns V sqrt(max(L, 0)) V^T e1,
// the eigenvalues clamped at 0 as JAX clamps them, so an indefinite T (a
// Ritz value just below 0 from float32 round-off) gives finite numbers.
// torch.linalg.eigh on a CUDA tensor reads its error flag on the host; this
// kernel keeps the PSE step's one host read.
//
// Design: cyclic Jacobi in float64 with the round-robin ordering, so each
// step rotates m/2 disjoint (p, q) pairs at once (m padded to even with a
// decoupled zero row): one thread per pair computes (c, s), then the block
// applies A <- P^T A P and V <- V P by columns and by rows. A fixed
// NSWEEP sweeps (quadratic convergence: float64 round-off by about the
// sixth for m <= 48), no data-dependent exit. A pair whose off-diagonal is
// exactly 0 is not rotated, so a decoupled block (an exhausted Krylov
// space) keeps exact zeros. A and V live in shared memory (m <= 48: 36 KB).
//
// What bounds it: latency, about NSWEEP (m - 1) x 3 block barriers; the
// work is O(NSWEEP m^3) float64 operations, microseconds at m = 16.

#include <cuda_runtime.h>

namespace {

constexpr int kSweeps = 12;

__device__ __forceinline__ int player(int j, int r, int mp) {
  return j == 0 ? 0 : 1 + (j - 1 + r) % (mp - 1);
}

__global__ void lanczos_sqrt_kernel(const double* __restrict__ alphas,
                                    const double* __restrict__ betas, double* __restrict__ out,
                                    int m) {
  extern __shared__ double sh[];
  const int mp = m + (m & 1);
  double* A = sh;            // [mp, mp]
  double* V = A + mp * mp;   // [mp, mp]
  double* cs = V + mp * mp;  // [mp / 2] cos, then [mp / 2] sin
  int* pq = reinterpret_cast<int*>(cs + mp);  // [mp / 2] p, then [mp / 2] q
  const int half = mp / 2;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int e = tid; e < mp * mp; e += nt) {
    const int i = e / mp, j = e - (e / mp) * mp;
    double a = 0.0;
    if (i < m && j < m) {
      if (i == j) a = alphas[i];
      else if (j == i + 1) a = betas[j];
      else if (i == j + 1) a = betas[i];
    }
    A[e] = a;
    V[e] = i == j ? 1.0 : 0.0;
  }
  __syncthreads();

  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    for (int r = 0; r < mp - 1; ++r) {
      for (int k = tid; k < half; k += nt) {
        const int a = player(k, r, mp), b = player(mp - 1 - k, r, mp);
        const int p = min(a, b), q = max(a, b);
        const double apq = A[p * mp + q];
        double c = 1.0, s = 0.0;
        if (apq != 0.0) {
          const double th = (A[q * mp + q] - A[p * mp + p]) / (2.0 * apq);
          double t = 1.0 / (fabs(th) + hypot(th, 1.0));
          if (th < 0.0) t = -t;
          c = 1.0 / sqrt(t * t + 1.0);
          s = t * c;
        }
        cs[k] = c;
        cs[half + k] = s;
        pq[k] = p;
        pq[half + k] = q;
      }
      __syncthreads();
      // columns: A <- A P, V <- V P
      for (int e = tid; e < mp * half; e += nt) {
        const int i = e / half, k = e - (e / half) * half;
        const int p = pq[k], q = pq[half + k];
        const double c = cs[k], s = cs[half + k];
        const double ap = A[i * mp + p], aq = A[i * mp + q];
        A[i * mp + p] = c * ap - s * aq;
        A[i * mp + q] = s * ap + c * aq;
        const double vp = V[i * mp + p], vq = V[i * mp + q];
        V[i * mp + p] = c * vp - s * vq;
        V[i * mp + q] = s * vp + c * vq;
      }
      __syncthreads();
      // rows: A <- P^T A
      for (int e = tid; e < mp * half; e += nt) {
        const int j = e / half, k = e - (e / half) * half;
        const int p = pq[k], q = pq[half + k];
        const double c = cs[k], s = cs[half + k];
        const double ap = A[p * mp + j], aq = A[q * mp + j];
        A[p * mp + j] = c * ap - s * aq;
        A[q * mp + j] = s * ap + c * aq;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < m; i += nt) {
    double acc = 0.0;
    for (int k = 0; k < mp; ++k) acc += V[i * mp + k] * sqrt(fmax(A[k * mp + k], 0.0)) * V[k];
    out[i] = acc;
  }
}

}  // namespace

// alphas: float64 [>= m]; betas: float64 [>= m] (betas[0] unused);
// out: float64 [m]. 1 <= m <= 48.
extern "C" int uammd_lanczos_sqrt_e1(void* alphas, void* betas, void* out, int m, void* stream) {
  if (m < 1 || m > 48) return static_cast<int>(cudaErrorInvalidValue);
  const int mp = m + (m & 1);
  const size_t smem = sizeof(double) * (2 * mp * mp + mp) + sizeof(int) * mp;
  lanczos_sqrt_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(alphas), static_cast<const double*>(betas),
      static_cast<double*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

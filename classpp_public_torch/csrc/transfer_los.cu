// Line-of-sight transfer scan, flat geometry: spherical Bessel j_l(x) by the
// upward three-term recurrence over l on the (q, tau) grid, contracted over
// tau against the trapezoid-weighted sources at every emitted l.
//
// Replaces classpp_public_tpu/models/transfer.py `_transfer_scan` (:360-463,
// the flat branch behind `_transfer_core` :175-188), whose plain PyTorch
// version is classpp_public_torch/models/transfer.py `transfer_los_plain`.
//
// What bounds it on an H100: float64 arithmetic. The recurrence touches every
// (q, tau) point at every l (3000 l x 1.6 M points in the Planck
// configuration) and each of the ~111 emitted l adds a log/exp series and five
// multiply-adds per point; W (5 x nq x ntau doubles, ~62 MB) is read once per
// emitted l. Design: one block per q and threads striding over tau, so each
// thread keeps j_{l-1}, j_{l-2}, x, 1/x and the forbidden-region threshold of
// its few points in registers for the whole scan and nothing but W and the
// outputs ever touches device memory. Whether l is emitted is the same for the
// whole block, so the emit branch never diverges. The five tau contractions
// are reduced in a fixed order (warp shuffles, then one warp over the warp
// sums): the result is deterministic, with no atomics.
//
// Any number of tau samples: the block holds kChunk = 1024 of them in
// registers (4 a thread) and runs the whole l scan once per chunk of the tau
// axis, the recurrence of a point depending on that point alone; each chunk's
// sums are added to the output in chunk order by the one thread that writes
// it. With ntau <= 1024 there is one chunk and the arithmetic is that of a
// single pass.
//
// Kept exactly from the JAX scan: the x >= 1e-12 clamp, the forbidden-region
// mask l <= x + 6 cbrt(x) + 2 (without it the recurrence amplifies round-off
// along the Neumann branch), the small-x (x < 1) series in log space with
// lgamma, and the late-source mask above l_late.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;          // threads per block (8 warps)
constexpr int kMaxPerThread = 4;       // tau points per thread in a chunk
constexpr int kChunk = kThreads * kMaxPerThread;   // tau points per pass of the scan
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
transfer_los_kernel(const double* __restrict__ W,        // (5, nq, ntau)
                    const double* __restrict__ taus,     // (ntau,)
                    double tau0,
                    const double* __restrict__ q,        // (nq,)
                    const int* __restrict__ emit_idx,    // (lmax + 1,)
                    const double* __restrict__ e_fac,    // (n_l,)
                    const double* __restrict__ late_mask,  // (ntau,) 0/1
                    double l_late, int nq, int ntau, int lmax,
                    double* __restrict__ out) {          // (n_l, 5, nq)
  const int iq = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  __shared__ double red[5][kWarps];

  const double qv = q[iq];
  const double ln2 = log(2.0);
  const size_t plane = (size_t)nq * ntau;
  const double* Wq = W + (size_t)iq * ntau;

  for (int t0 = 0; t0 < ntau; t0 += kChunk) {
    double x[kMaxPerThread], ix[kMaxPerThread], thr[kMaxPerThread];
    double jm1[kMaxPerThread], jm2[kMaxPerThread];
    bool valid[kMaxPerThread];
#pragma unroll
    for (int s = 0; s < kMaxPerThread; ++s) {
      const int it = t0 + tid + s * kThreads;
      valid[s] = it < ntau;
      const double chi = valid[s] ? tau0 - taus[it] : 1.0;
      const double xv = fmax(qv * chi, 1e-12);
      const double inv = 1.0 / xv;
      const double x2 = xv * xv;
      x[s] = xv;
      ix[s] = inv;
      thr[s] = xv + 6.0 * cbrt(xv) + 2.0;
      if (xv < 0.3) {
        jm2[s] = 1.0 - x2 / 6.0 * (1.0 - x2 / 20.0 * (1.0 - x2 / 42.0));
        jm1[s] = xv / 3.0 * (1.0 - x2 / 10.0 * (1.0 - x2 / 28.0));
      } else {
        const double sn = sin(xv), cs = cos(xv);
        jm2[s] = sn * inv;
        jm1[s] = (sn * inv - cs) * inv;
      }
    }
    for (int li = 2; li <= lmax; ++li) {
      const double l = (double)li;
      double jl[kMaxPerThread];
#pragma unroll
      for (int s = 0; s < kMaxPerThread; ++s) {
        const double v = (2.0 * l - 1.0) * ix[s] * jm1[s] - jm2[s];
        jl[s] = (l <= thr[s]) ? v : 0.0;
      }
      const int ei = emit_idx[li];
      if (ei >= 0) {
        const double lndf = lgamma(2.0 * l + 2.0) - l * ln2 - lgamma(l + 1.0);
        const double lndf1 = lgamma(2.0 * l + 4.0) - (l + 1.0) * ln2 - lgamma(l + 2.0);
        const double c1 = 2.0 * l + 3.0, c1b = 2.0 * l + 5.0;
        const double ef = e_fac[ei];
        const bool late_on = l > l_late;
        double acc[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int s = 0; s < kMaxPerThread; ++s) {
          if (!valid[s]) continue;
          const int it = t0 + tid + s * kThreads;
          const double xv = x[s], inv = ix[s];
          double jl_e, jp_e;
          if (xv < 1.0) {
            const double x2 = xv * xv;
            const double lnx = log(xv);
            const double corr = 1.0 - x2 / (2.0 * c1) * (1.0 - x2 / (4.0 * (c1 + 2.0))
                                                         * (1.0 - x2 / (6.0 * (c1 + 4.0))));
            const double corr1 = 1.0 - x2 / (2.0 * c1b) * (1.0 - x2 / (4.0 * (c1b + 2.0))
                                                           * (1.0 - x2 / (6.0 * (c1b + 4.0))));
            const double js = exp(l * lnx - lndf) * corr;
            const double js1 = exp((l + 1.0) * lnx - lndf1) * corr1;
            jl_e = js;
            jp_e = l * inv * js - js1;
          } else {
            jl_e = jl[s];
            jp_e = jm1[s] - (l + 1.0) * inv * jl[s];
          }
          const double jpp = -2.0 * inv * jp_e - (1.0 - l * (l + 1.0) * inv * inv) * jl_e;
          const double rad_t2 = 0.5 * (3.0 * jpp + jl_e);
          const double rad_e = ef * jl_e * inv * inv;
          const double late = late_on ? late_mask[it] : 1.0;
          acc[0] += Wq[it] * jl_e;
          acc[1] += Wq[plane + it] * late * jp_e;
          acc[2] += Wq[2 * plane + it] * late * rad_t2;
          acc[3] += Wq[3 * plane + it] * late * rad_e;
          acc[4] += Wq[4 * plane + it] * jl_e;
        }
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          const double v = warp_sum(acc[c]);
          if (lane == 0) red[c][warp] = v;
        }
        __syncthreads();
        if (warp == 0) {
#pragma unroll
          for (int c = 0; c < 5; ++c) {
            double v = lane < kWarps ? red[c][lane] : 0.0;
            v = warp_sum(v);
            if (lane == 0) {
              double& o = out[((size_t)ei * 5 + c) * nq + iq];
              o = t0 == 0 ? v : o + v;
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int s = 0; s < kMaxPerThread; ++s) {
        jm2[s] = jm1[s];
        jm1[s] = jl[s];
      }
    }
  }  // tau chunk
}

}  // namespace

extern "C" int transfer_los_launch(const void* W, const void* taus, double tau0,
                                   const void* q, const void* emit_idx, const void* e_fac,
                                   const void* late_mask, double l_late, int nq, int ntau,
                                   int lmax, int n_l, void* out, void* stream) {
  if (nq <= 0 || ntau <= 0 || n_l <= 0)
    return (int)cudaErrorInvalidValue;
  transfer_los_kernel<<<nq, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)W, (const double*)taus, tau0, (const double*)q,
      (const int*)emit_idx, (const double*)e_fac, (const double*)late_mask, l_late, nq,
      ntau, lmax, (double*)out);
  return (int)cudaGetLastError();
}

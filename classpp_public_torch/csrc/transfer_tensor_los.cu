// Tensor line-of-sight transfer scan, flat geometry: spherical Bessel j_l(x)
// by the upward three-term recurrence over l on the (q, tau) grid, and at
// every emitted l the tensor radial functions (T2, E, B) contracted over tau
// against the trapezoid-weighted sources S_T2 (T2) and S_P (E and B).
//
// Replaces classpp_public_tpu/models/transfer.py `_transfer_tensor_core`
// (:687-700, exported under "tr_tensor") -> `_tensor_scan` (:854-911), whose
// plain PyTorch version is classpp_public_torch/models/transfer.py
// `transfer_tensor_los_plain`.
//
// What bounds it on an H100: float64 arithmetic, far below the card's rate at
// these sizes (~550 q x 592 tau, l to 500, 49 emitted l): the launch is a few
// hundred blocks of serial recurrence. Design as transfer_los.cu: one block
// per q, threads striding over tau, each thread keeping j_{l-1}, j_{l-2}, x,
// 1/x and the forbidden-region threshold of its points in registers through
// the whole scan; W (2 x nq x ntau) is read only at emitted l. Whether l is
// emitted is the same for the whole block, so the emit branch never diverges.
// The three tau contractions reduce in a fixed order (warp shuffles, then one
// warp over the warp sums): deterministic, no atomics.
//
// Kept exactly from the JAX scan: the x >= 1e-12 clamp, the forbidden-region
// mask l <= x + 6 cbrt(x) + 2, the small-x (x < 1) series, and the q-neglect
// masks l >= (q - dk) ra_rec per output. The series' log double factorials
// are computed once per emitted l on the host (lgamma), so device lgamma
// never enters.
//
// Any number of tau samples: the block holds kChunk = 1024 of them in
// registers (4 a thread) and runs the whole l scan once per chunk of the tau
// axis, the recurrence of a point depending on that point alone; each chunk's
// sums are added to the output in chunk order by the one thread that writes
// it. With ntau <= 1024 there is one chunk and the arithmetic is that of a
// single pass.

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

struct Neglect {
  double dk[3];
};

__global__ void __launch_bounds__(kThreads)
transfer_tensor_los_kernel(const double* __restrict__ W,       // (2, nq, ntau)
                           const double* __restrict__ taus,    // (ntau,)
                           double tau0,
                           const double* __restrict__ q,       // (nq,)
                           const int* __restrict__ emit_idx,   // (lmax + 1,)
                           const double* __restrict__ per_l,   // (3, n_l): t2_fac, lndf, lndf1
                           double ra_rec, Neglect ng, int nq, int ntau, int lmax, int n_l,
                           double* __restrict__ out) {         // (n_l, 3, nq)
  const int iq = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  __shared__ double red[3][kWarps];

  const double qv = q[iq];
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
        const double t2f = per_l[ei], lndf = per_l[n_l + ei], lndf1 = per_l[2 * n_l + ei];
        const double c1 = 2.0 * l + 3.0, c1b = 2.0 * l + 5.0;
        double acc[3] = {0.0, 0.0, 0.0};
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
          const double rad_t2 = t2f * jl_e * inv * inv;
          const double rad_e = 0.25 * (jpp + 4.0 * inv * jp_e - (1.0 - 2.0 * inv * inv) * jl_e);
          const double rad_b = 0.5 * (jp_e + 2.0 * inv * jl_e);
          const double wt = Wq[it], wp = Wq[plane + it];
          acc[0] += wt * rad_t2;
          acc[1] += wp * rad_e;
          acc[2] += wp * rad_b;
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const double v = warp_sum(acc[c]);
          if (lane == 0) red[c][warp] = v;
        }
        __syncthreads();
        if (warp == 0) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            double v = lane < kWarps ? red[c][lane] : 0.0;
            v = warp_sum(v);
            const bool keep = l >= (qv - ng.dk[c]) * ra_rec;
            if (lane == 0) {
              double& o = out[((size_t)ei * 3 + c) * nq + iq];
              const double r = keep ? v : 0.0;
              o = t0 == 0 ? r : o + r;
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

// neglect_dk: 3 host doubles (t2, e, b); every other pointer is a device
// pointer.
extern "C" int transfer_tensor_los_launch(const void* W, const void* taus, double tau0,
                                          const void* q, const void* emit_idx, const void* per_l,
                                          double ra_rec, const double* neglect_dk, int nq,
                                          int ntau, int lmax, int n_l, void* out, void* stream) {
  if (nq <= 0 || ntau <= 0 || n_l <= 0)
    return (int)cudaErrorInvalidValue;
  const Neglect ng{{neglect_dk[0], neglect_dk[1], neglect_dk[2]}};
  transfer_tensor_los_kernel<<<nq, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)W, (const double*)taus, tau0, (const double*)q, (const int*)emit_idx,
      (const double*)per_l, ra_rec, ng, nq, ntau, lmax, n_l, (double*)out);
  return (int)cudaGetLastError();
}

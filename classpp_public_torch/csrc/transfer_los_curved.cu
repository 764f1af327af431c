// Line-of-sight transfer scan, curved geometry: hyperspherical Bessel
// functions Phi_l^nu(x) by the upward three-term recurrence over l on the
// (q, tau) grid, contracted over tau against the trapezoid-weighted sources
// at every emitted l with the curved radial functions (transfer_radial_function
// :3413-3445).
//
// Replaces classpp_public_tpu/models/transfer.py `_transfer_scan_curved`
// (:534-659, with `_curved_series_phi` :494, behind `_transfer_core`
// :175-188 when sgnK != 0), whose plain PyTorch version is
// classpp_public_torch/models/transfer.py `transfer_los_curved_plain`.
//
// What bounds it on an H100: float64 arithmetic. Every (q, tau) point takes
// one recurrence step per l (~10 operations; the division by sqrtK(l) is one
// reciprocal per (q, l), shared by the block's points) and each
// emitted l adds the radial functions (d2Phi from the hyperspherical
// equation, csc^2, and at beta x < 1 the series: a log, an exp and two
// polynomials); W (5 x nq x ntau doubles) is read at emitted l only. Design
// as transfer_los.cu: one block per q, threads striding over tau, each
// thread holding x, sin_K, cot_K, beta x, beta sin_K, the forbidden-region
// base and Phi_{l-1}, Phi_{l-2} of its points in registers for the whole
// scan. sqrtK(l), the series prefactor lnC and the series coefficients
// depend on (q, l) only: every thread of the block computes them alike, so
// whether l is emitted and every scalar is uniform in the block. The five tau
// contractions are reduced in a fixed order (warp shuffles, then one warp
// over the warp sums): deterministic, no atomics. The log double factorials
// of the series come per emitted l from the host, so device lgamma never
// enters.
//
// Kept exactly from the JAX scan (hyperspherical.cuh): the x >= 1e-12 and
// beta x >= 1e-12 clamps, the masks (closed: the buffer capped by the
// distance to nu and l + 1/2 < nu, by a select), the clamped log1p of lnC at
// every l, the series at beta x < 1, and the late-source mask above l_late.
// The q-neglect masks (in k(q)) and the Limber rows act on the result in
// torch, as on the flat path.
//
// Any number of tau samples: the block holds kChunk = 1024 of them in
// registers (4 a thread) and runs the whole l scan once per chunk of the tau
// axis, the recurrence of a point depending on that point alone; each chunk's
// sums are added to the output in chunk order by the one thread that writes
// it. With ntau <= 1024 there is one chunk and the arithmetic is that of a
// single pass.

#include <cuda_runtime.h>
#include <math.h>

#include "hyperspherical.cuh"

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
transfer_los_curved_kernel(const double* __restrict__ W,        // (5, nq, ntau)
                           const double* __restrict__ taus,     // (ntau,)
                           double tau0,
                           const double* __restrict__ q,        // (nq,)
                           const double* __restrict__ kq,       // (nq,) k(q)
                           const int* __restrict__ emit_idx,    // (lmax + 1,)
                           const double* __restrict__ per_l,    // (2, n_l): e_fac, lndf
                           const double* __restrict__ late_mask,  // (ntau,) 0/1
                           double l_late, double K, int sgnK, int nq, int ntau, int lmax,
                           int n_l, double* __restrict__ out) {  // (n_l, 5, nq)
  const int iq = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  __shared__ double red[5][kWarps];

  const double sab = sqrt(fabs(K)), Kt = sgnK > 0 ? 1.0 : -1.0;
  const double beta = q[iq] / sab, beta2 = beta * beta;
  const double kv = kq[iq], k2 = kv * kv;
  const double s_l2 = sqrt(1.0 - 3.0 * K / k2);
  const double absK_over_k2 = fabs(K) / k2, sab_over_k = sab / kv;
  const size_t plane = (size_t)nq * ntau;
  const double* Wq = W + (size_t)iq * ntau;

  for (int t0 = 0; t0 < ntau; t0 += kChunk) {
    hs::Point pt[kMaxPerThread];
    bool valid[kMaxPerThread];
#pragma unroll
    for (int s = 0; s < kMaxPerThread; ++s) {
      const int it = t0 + tid + s * kThreads;
      valid[s] = it < ntau;
      pt[s] = hs::seed(valid[s] ? tau0 - taus[it] : 1.0, sab, beta, beta2, sgnK);
    }
    double sq_lm1 = hs::sqrt_k(beta2, Kt, 1.0);
    double lnC = 0.5 * log1p(-Kt * 1.0 / beta2);
    for (int li = 2; li <= lmax; ++li) {
      const double l = (double)li;
      const double sq_l = hs::sqrt_k(beta2, Kt, l), inv_sq_l = 1.0 / sq_l;
      double pl[kMaxPerThread];
#pragma unroll
      for (int s = 0; s < kMaxPerThread; ++s)
        pl[s] = hs::step(pt[s], l, beta, inv_sq_l, sq_lm1, sgnK);
      lnC = hs::ln_c_step(lnC, l, beta2, Kt);
      const int ei = emit_idx[li];
      if (ei >= 0) {
        const double ef = per_l[ei], lndf = per_l[n_l + ei];
        const hs::Series c = hs::series(l, beta2, Kt);
        const bool late_on = l > l_late;
        double acc[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int s = 0; s < kMaxPerThread; ++s) {
          if (!valid[s]) continue;
          const int it = t0 + tid + s * kThreads;
          const hs::Point& p = pt[s];
          double pl_e, dp_e, d2p;
          hs::emitted(p, l, pl[s], sq_l, lnC, lndf, c, beta2, Kt, pl_e, dp_e, d2p);
          const double csc2 = fabs(K) / (k2 * p.sinK * p.sinK);
          const double rad_t1 = sab_over_k * dp_e;
          const double rad_t2 = (3.0 * absK_over_k2 * d2p + pl_e) / (2.0 * s_l2);
          const double rad_e = (ef / s_l2) * csc2 * pl_e;
          const double late = late_on ? late_mask[it] : 1.0;
          acc[0] += Wq[it] * pl_e;
          acc[1] += Wq[plane + it] * late * rad_t1;
          acc[2] += Wq[2 * plane + it] * late * rad_t2;
          acc[3] += Wq[3 * plane + it] * late * rad_e;
          acc[4] += Wq[4 * plane + it] * pl_e;
        }
#pragma unroll
        for (int cc = 0; cc < 5; ++cc) {
          const double v = warp_sum(acc[cc]);
          if (lane == 0) red[cc][warp] = v;
        }
        __syncthreads();
        if (warp == 0) {
#pragma unroll
          for (int cc = 0; cc < 5; ++cc) {
            double v = lane < kWarps ? red[cc][lane] : 0.0;
            v = warp_sum(v);
            if (lane == 0) {
              double& o = out[((size_t)ei * 5 + cc) * nq + iq];
              const double r = v;
              o = t0 == 0 ? r : o + r;
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int s = 0; s < kMaxPerThread; ++s) {
        pt[s].pm2 = pt[s].pm1;
        pt[s].pm1 = pl[s];
      }
      sq_lm1 = sq_l;
    }
  }  // tau chunk
}

}  // namespace

extern "C" int transfer_los_curved_launch(const void* W, const void* taus, double tau0,
                                          const void* q, const void* kq, const void* emit_idx,
                                          const void* per_l, const void* late_mask,
                                          double l_late, double K, int sgnK, int nq, int ntau,
                                          int lmax, int n_l, void* out, void* stream) {
  if (nq <= 0 || ntau <= 0 || n_l <= 0 || sgnK == 0)
    return (int)cudaErrorInvalidValue;
  transfer_los_curved_kernel<<<nq, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)W, (const double*)taus, tau0, (const double*)q, (const double*)kq,
      (const int*)emit_idx, (const double*)per_l, (const double*)late_mask, l_late, K, sgnK, nq,
      ntau, lmax, n_l, (double*)out);
  return (int)cudaGetLastError();
}

// Tensor line-of-sight transfer scan, curved geometry: hyperspherical Bessel
// functions Phi_l^nu(x), nu = q/sqrt|K| with q^2 = k^2 + 3K, by the upward
// three-term recurrence over l on the (q, tau) grid, and at every emitted l
// the curved tensor radial functions (T2, E, B; transfer_radial_function
// TENSOR_* :3486-3520) contracted over tau against the trapezoid-weighted
// sources S_T2 (T2) and S_P (E and B).
//
// Replaces classpp_public_tpu/models/transfer.py `_tensor_scan_curved`
// (:757-852, behind `_transfer_tensor_core` :687-700 when sgnK != 0), whose
// plain PyTorch version is classpp_public_torch/models/transfer.py
// `transfer_tensor_los_curved_plain`.
//
// What bounds it on an H100: float64 arithmetic, far below the card's rate at
// these sizes (a few hundred q x ~590 tau, l to 500, 49 emitted l): the
// launch is a few hundred blocks of serial recurrence. Design as
// transfer_los_curved.cu (the recurrence, its masks and the series are
// hyperspherical.cuh): one block per q, threads striding over tau, the
// point's geometry and its last two Phi in registers; per point the radial
// functions also need csc_K = sqrt|K|/(k sin_K) and cot_K = csc_K cos_K, per q
// the factors sqrt(1 - K/k^2), sqrt(1 + 2K/k^2), sqrt(1 + 3K/k^2). The three
// tau contractions reduce in a fixed order (warp shuffles, then one warp over
// the warp sums): deterministic, no atomics. The q-neglect masks
// l >= (k(q) - dk) ra_rec act on the sums in the kernel, as in the flat
// tensor scan.
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

struct Neglect {
  double dk[3];
};

__global__ void __launch_bounds__(kThreads)
transfer_tensor_los_curved_kernel(const double* __restrict__ W,      // (2, nq, ntau)
                                  const double* __restrict__ taus,   // (ntau,)
                                  double tau0,
                                  const double* __restrict__ q,      // (nq,)
                                  const double* __restrict__ kq,     // (nq,) k(q)
                                  const int* __restrict__ emit_idx,  // (lmax + 1,)
                                  const double* __restrict__ per_l,  // (2, n_l): t2_fac, lndf
                                  double ra_rec, Neglect ng, double K, int sgnK, int nq,
                                  int ntau, int lmax, int n_l,
                                  double* __restrict__ out) {        // (n_l, 3, nq)
  const int iq = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  __shared__ double red[3][kWarps];

  const double sab = sqrt(fabs(K)), Kt = sgnK > 0 ? 1.0 : -1.0;
  const double beta = q[iq] / sab, beta2 = beta * beta;
  const double kv = kq[iq], k2 = kv * kv;
  const double ssqrt2 = sqrt(1.0 - K / k2), si = sqrt(1.0 + 2.0 * K / k2);
  const double ssqrt2i = sqrt(1.0 + 3.0 * K / k2);
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
        const double t2f = per_l[ei], lndf = per_l[n_l + ei];
        const hs::Series c = hs::series(l, beta2, Kt);
        double acc[3] = {0.0, 0.0, 0.0};
#pragma unroll
        for (int s = 0; s < kMaxPerThread; ++s) {
          if (!valid[s]) continue;
          const int it = t0 + tid + s * kThreads;
          const hs::Point& p = pt[s];
          double pl_e, dp_e, d2p;
          hs::emitted(p, l, pl[s], sq_l, lnC, lndf, c, beta2, Kt, pl_e, dp_e, d2p);
          const double cscKgen = sab / (kv * p.sinK);
          const double cotKgen = cscKgen * p.cosK;
          const double rad_t2 = t2f / (si * ssqrt2) * cscKgen * cscKgen * pl_e;
          const double rad_e = 0.25 / (si * ssqrt2) * (
              absK_over_k2 * d2p + 4.0 * cotKgen * sab_over_k * dp_e
              - (1.0 + 4.0 * K / k2 - 2.0 * cotKgen * cotKgen) * pl_e);
          const double rad_b = 0.5 * ssqrt2i / (ssqrt2 * si) * (sab_over_k * dp_e
                                                                + 2.0 * cotKgen * pl_e);
          const double wt = Wq[it], wp = Wq[plane + it];
          acc[0] += wt * rad_t2;
          acc[1] += wp * rad_e;
          acc[2] += wp * rad_b;
        }
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          const double v = warp_sum(acc[cc]);
          if (lane == 0) red[cc][warp] = v;
        }
        __syncthreads();
        if (warp == 0) {
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) {
            double v = lane < kWarps ? red[cc][lane] : 0.0;
            v = warp_sum(v);
            const bool keep = l >= (kv - ng.dk[cc]) * ra_rec;
            if (lane == 0) {
              double& o = out[((size_t)ei * 3 + cc) * nq + iq];
              const double r = keep ? v : 0.0;
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

// neglect_dk: 3 host doubles (t2, e, b); every other pointer is a device
// pointer.
extern "C" int transfer_tensor_los_curved_launch(const void* W, const void* taus, double tau0,
                                                 const void* q, const void* kq,
                                                 const void* emit_idx, const void* per_l,
                                                 double ra_rec, const double* neglect_dk,
                                                 double K, int sgnK, int nq, int ntau, int lmax,
                                                 int n_l, void* out, void* stream) {
  if (nq <= 0 || ntau <= 0 || n_l <= 0 || sgnK == 0)
    return (int)cudaErrorInvalidValue;
  const Neglect ng{{neglect_dk[0], neglect_dk[1], neglect_dk[2]}};
  transfer_tensor_los_curved_kernel<<<nq, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)W, (const double*)taus, tau0, (const double*)q, (const double*)kq,
      (const int*)emit_idx, (const double*)per_l, ra_rec, ng, K, sgnK, nq, ntau, lmax, n_l,
      (double*)out);
  return (int)cudaGetLastError();
}

// Selection-window line-of-sight scan of the number counts and galaxy
// lensing: spherical Bessel j_l(x) by the upward three-term recurrence over l
// on each row's (k, tau) grid, and at every emitted l the row's radial
// function (j_l, j_l' or j_l'') contracted over tau against the row's
// trapezoid-weighted windowed source:
//   Delta[l, r, k] = sum_tau Wrow[r, k, tau] rad_r(l, x[r, k, tau]).
//
// Replaces classpp_public_tpu/models/numbercounts.py `_nc_scan` (:629-683,
// behind `_nc_core` :618), whose plain PyTorch version is
// classpp_public_torch/models/numbercounts.py `nc_scan_plain`.
//
// What bounds it on an H100: float64 arithmetic. Every (row, k, tau) point
// takes one recurrence step per l (~6 operations) and each emitted l adds the
// radial function (~60 with the x < 1 series); x and Wrow (nrow x nk x ntau
// doubles each) are read once per chunk and once per emitted l. Design: one
// block per (row, k) and 128 threads striding over tau, each thread keeping
// x, 1/x, the forbidden-region threshold and j_{l-1}, j_{l-2} of its points in
// registers for the whole scan. A block is one row, so the radial code and
// whether l is emitted are uniform in the block and no branch diverges. The
// tau sum at an emitted l is reduced in a fixed order (warp shuffles, then
// one warp over the four warp sums): deterministic, no atomics. Any number of
// tau samples: the block holds kChunk = 512 of them (the default row length)
// in registers and runs the l scan once per chunk, adding each chunk's sums to
// the output in chunk order from the one thread that writes it.
//
// Kept exactly from the JAX scan: the x >= 1e-12 clamp, j_0 and j_1 from the
// x < 0.3 series or sin/cos, the mask l <= x + 6 cbrt(x) + 2 (zeroing j_l past
// it), and at an emitted l the x < 1 series for j_l and j_{l+1}, j_l' from the
// previous (possibly zeroed) j_{l-1}, and j_l'' from the Bessel equation. The
// series' log double factorials come per emitted l from the host (lgamma in
// float64), so device lgamma never enters.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;          // threads per block (4 warps)
constexpr int kMaxPerThread = 4;       // tau points per thread in a chunk
constexpr int kChunk = kThreads * kMaxPerThread;   // tau points per pass of the scan
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
nc_scan_kernel(const double* __restrict__ x_in,      // (nrow, nk, ntau)
               const double* __restrict__ Wrow,      // (nrow, nk, ntau)
               const int* __restrict__ radial,       // (nrow,) 0 j_l, 1 j_l', 2 j_l''
               const int* __restrict__ emit_idx,     // (lmax + 1,)
               const double* __restrict__ per_l,     // (2, n_l): lndf, lndf1
               int nrow, int nk, int ntau, int lmax, int n_l,
               double* __restrict__ out) {           // (n_l, nrow, nk)
  const int r = blockIdx.x / nk, ik = blockIdx.x - r * nk;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  __shared__ double red[kWarps];

  const int code = radial[r];
  const size_t base = ((size_t)r * nk + ik) * ntau;
  const double* xr = x_in + base;
  const double* Wr = Wrow + base;
  double* o_row = out + (size_t)r * nk + ik;
  const size_t o_stride = (size_t)nrow * nk;

  for (int t0 = 0; t0 < ntau; t0 += kChunk) {
    double x[kMaxPerThread], ix[kMaxPerThread], thr[kMaxPerThread];
    double jm1[kMaxPerThread], jm2[kMaxPerThread];
    bool valid[kMaxPerThread];
#pragma unroll
    for (int s = 0; s < kMaxPerThread; ++s) {
      const int it = t0 + tid + s * kThreads;
      valid[s] = it < ntau;
      const double xv = fmax(valid[s] ? xr[it] : 1.0, 1e-12);
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
        const double lndf = per_l[ei], lndf1 = per_l[n_l + ei];
        const double c1 = 2.0 * l + 3.0, c1b = 2.0 * l + 5.0;
        double acc = 0.0;
#pragma unroll
        for (int s = 0; s < kMaxPerThread; ++s) {
          if (!valid[s]) continue;
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
          double rad;
          if (code == 0) {
            rad = jl_e;
          } else if (code == 1) {
            rad = jp_e;
          } else {
            rad = -2.0 * inv * jp_e - (1.0 - l * (l + 1.0) * inv * inv) * jl_e;
          }
          acc += Wr[t0 + tid + s * kThreads] * rad;
        }
        const double v = warp_sum(acc);
        if (lane == 0) red[warp] = v;
        __syncthreads();
        if (warp == 0) {
          const double w = warp_sum(lane < kWarps ? red[lane] : 0.0);
          if (lane == 0) {
            double& o = o_row[(size_t)ei * o_stride];
            o = t0 == 0 ? w : o + w;
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

// Every pointer is a device pointer: x, Wrow (nrow, nk, ntau) float64, radial
// (nrow) int32, emit_idx (lmax + 1) int32, per_l (2, n_l) float64, out
// (n_l, nrow, nk) float64.
extern "C" int nc_scan_launch(const void* x, const void* Wrow, const void* radial,
                              const void* emit_idx, const void* per_l, int nrow, int nk,
                              int ntau, int lmax, int n_l, void* out, void* stream) {
  if (nrow <= 0 || nk <= 0 || ntau <= 0 || n_l <= 0 || lmax < 2
      || (long long)nrow * nk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  nc_scan_kernel<<<nrow * nk, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)x, (const double*)Wrow, (const int*)radial, (const int*)emit_idx,
      (const double*)per_l, nrow, nk, ntau, lmax, n_l, (double*)out);
  return (int)cudaGetLastError();
}

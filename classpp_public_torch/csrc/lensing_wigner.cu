// Lensed CMB spectra by the correlation-function method: twelve Wigner
// d^l_{m m'}(mu) three-term recurrences carried over l, one thread per mu, in
// three passes: (1) the deflection correlations Cgl, Cgl2; (2) the lensed
// correlation functions ksi, ksiX, ksi+, ksi-; (3) the projection
// C_l = 2 pi sum_mu w8 ksi d, the only place where mu values mix.
//
// Replaces classpp_public_tpu/models/lensing.py `_lensing_impl` (:94-284,
// behind `_lensing_core` :67-81), whose plain PyTorch version is
// classpp_public_torch/models/lensing.py `lensing_wigner_plain`.
//
// What bounds it on an H100: latency. Each pass is ~3000 sequential l steps
// and the fast mode has 374 mu values, i.e. three blocks of 128 threads on a
// 132-SM card; per step a thread does ~12 recurrences and a few dozen
// float64 operations, all from registers. The design keeps every (d_l,
// d_{l-1}) pair, the correlations and the accumulators in registers so that no
// step touches device memory except the per-l tables (uniform across threads,
// served from cache). Pass 3 reduces over mu per l: each block writes its
// partial sums to `partial` (nblocks, l_lensed_max + 1, 4) and a second launch
// of this file's reduce kernel sums the blocks in a fixed order, so the result
// is deterministic, with no atomics. The accurate mode (~3070 mu) runs on the
// same code with more blocks. Making it fast (many l per block in parallel
// with a recurrence split) is later work.
//
// Kept exactly from the JAX scan: the B_{l+1} > 0 guard of the recurrence,
// the seed injection at l = m, and the fast-mode subtraction of the unlensed
// d and the unlensed add-back.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 12;
// (m, m') of the twelve pairs, in classpp_public_torch/models/lensing.py PAIRS
// order: 00, 11, 1-1, 2-2, 20, 3-1, 4-2, 22, 31, 3-3, 40, 4-4
__constant__ int kM[kPairs] = {0, 1, 1, 2, 2, 3, 4, 2, 3, 3, 4, 4};
enum { P00 = 0, P11, P1M1, P2M2, P20, P3M1, P4M2, P22, P31, P3M3, P40, P4M4 };
// CT_TYPES column order: tt, ee, te, bb, pp, tp, ep
enum { TT = 0, EE, TE, BB, PP, TP, EP };
constexpr int kNct = 7;
constexpr double kPi = 3.14159265358979323846;

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// d^{l+1} from d^l, d^{l-1} for pair p: B_{l+1} d^{l+1} =
// (2l+1)(mu - shift_l) d^l - B_l d^{l-1}, zero where B_{l+1} = 0
__device__ __forceinline__ double d_step(const double* __restrict__ B,
                                         const double* __restrict__ S, int ld, int p,
                                         int l, double mu, double dl, double dlm1) {
  const double Bn = B[p * ld + l + 1];
  if (!(Bn > 0.0)) return 0.0;
  return ((2.0 * l + 1.0) * (mu - S[p * ld + l]) * dl - B[p * ld + l] * dlm1) / fmax(Bn, 1e-300);
}

__global__ void __launch_bounds__(kThreads)
lensing_passes_kernel(const double* __restrict__ cl,     // (lmax + 1, 7)
                      const double* __restrict__ w_pp,   // (lmax + 1,)
                      const double* __restrict__ sq,     // (5, lmax + 1)
                      const double* __restrict__ mu_all, // (nmu,)
                      const double* __restrict__ w8_all, // (nmu,)
                      const double* __restrict__ B,      // (12, lmax + 2)
                      const double* __restrict__ S,      // (12, lmax + 2)
                      const double* __restrict__ seeds,  // (12, nmu)
                      int nmu, int lmax, int l_lensed_max, int fast,
                      double* __restrict__ partial) {    // (nblocks, l_lensed_max + 1, 4)
  const int tid = threadIdx.x;
  const int imu = blockIdx.x * kThreads + tid;
  const bool valid = imu < nmu;
  const int lane = tid & 31, warp = tid >> 5;
  const int ld = lmax + 2;
  const int ls = lmax + 1;
  __shared__ double red[4][kWarps];

  const double mu = valid ? mu_all[imu] : 0.0;
  const double w8 = valid ? w8_all[imu] : 0.0;
  double seed[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) seed[p] = valid ? seeds[p * nmu + imu] : 0.0;

  // --- pass 1: Cgl, Cgl2 (d11 and d1-1 from their seeds at l = 1)
  double a = seed[P11], am = 0.0, b = seed[P1M1], bm = 0.0;
  double Cgl = 0.0, Cgl2 = 0.0;
  for (int l = 1; l <= lmax; ++l) {
    if (l >= 2) {
      Cgl = Cgl + w_pp[l] * a;
      Cgl2 = Cgl2 + w_pp[l] * b;
    }
    const double an = d_step(B, S, ld, P11, l, mu, a, am);
    const double bn = d_step(B, S, ld, P1M1, l, mu, b, bm);
    am = a; a = an;
    bm = b; b = bn;
  }
  double Cgl_at_1 = 0.0;
  for (int l = 2; l <= lmax; ++l) Cgl_at_1 += w_pp[l];
  const double sigma2 = Cgl_at_1 - Cgl;

  // --- pass 2: ksi, ksiX, ksi+, ksi- (all twelve pairs from l = 0)
  double d[kPairs], dm[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    d[p] = (kM[p] == 0) ? 1.0 : 0.0;
    dm[p] = 0.0;
  }
  double ksi = 0.0, ksiX = 0.0, ksip = 0.0, ksim = 0.0;
  for (int l = 0; l <= lmax; ++l) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p)
      if (l == kM[p]) d[p] = seed[p];
    if (l >= 2) {
      const double lf = (double)l;
      const double fac = lf * (lf + 1.0) / 4.0;
      const double fac1 = (2.0 * lf + 1.0) / (4.0 * kPi);
      const double X000 = exp(-fac * sigma2);
      const double Xp000 = -fac * X000;
      const double X220 = 0.25 * sq[0 * ls + l] * X000;
      const double X022 = X000 * (1.0 + sigma2 * (1.0 + 0.5 * sigma2));
      const double Xp022 = -(fac - 1.0) * X022;
      const double X242 = 0.25 * sq[3 * ls + l] * X000;
      const double X121 = -0.5 * sq[1 * ls + l] * X000 * (1.0 + 2.0 / 3.0 * sigma2);
      const double X132 = -0.5 * sq[2 * ls + l] * X000 * (1.0 + 5.0 / 3.0 * sigma2);
      double lens_tt = (X000 * X000 * d[P00]
                        + Xp000 * Xp000 * d[P1M1] * Cgl2 * 8.0 / fmax(lf * (lf + 1.0), 1e-300)
                        + (Xp000 * Xp000 * d[P00] + X220 * X220 * d[P2M2]) * Cgl2 * Cgl2);
      double lens_te = (X022 * X000 * d[P20]
                        + Cgl2 * 2.0 * Xp000 / fmax(sq[4 * ls + l], 1e-300)
                              * (X121 * d[P11] + X132 * d[P3M1])
                        + 0.5 * Cgl2 * Cgl2 * ((2.0 * Xp022 * Xp000 + X220 * X220) * d[P20]
                                               + X220 * X242 * d[P4M2]));
      double lens_p = (X022 * X022 * d[P22] + 2.0 * Cgl2 * X132 * X121 * d[P31]
                       + Cgl2 * Cgl2 * (Xp022 * Xp022 * d[P22] + X242 * X220 * d[P40]));
      double lens_m = (X022 * X022 * d[P2M2]
                       + Cgl2 * (X121 * X121 * d[P1M1] + X132 * X132 * d[P3M3])
                       + 0.5 * Cgl2 * Cgl2 * (2.0 * Xp022 * Xp022 * d[P2M2]
                                              + X220 * X220 * d[P00] + X242 * X242 * d[P4M4]));
      if (fast) {
        lens_tt = lens_tt - d[P00];
        lens_te = lens_te - d[P20];
        lens_p = lens_p - d[P22];
        lens_m = lens_m - d[P2M2];
      }
      const double* c = cl + (size_t)l * kNct;
      ksi = ksi + fac1 * c[TT] * lens_tt;
      ksiX = ksiX + fac1 * c[TE] * lens_te;
      ksip = ksip + fac1 * (c[EE] + c[BB]) * lens_p;
      ksim = ksim + fac1 * (c[EE] - c[BB]) * lens_m;
    }
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const double dn = d_step(B, S, ld, p, l, mu, d[p], dm[p]);
      dm[p] = d[p];
      d[p] = dn;
    }
  }

  // --- pass 3: per-l block sums of w8 ksi d for tt, ee, te, bb
  const int use[4] = {P00, P20, P22, P2M2};
  double e[4], em[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    e[u] = (kM[use[u]] == 0) ? 1.0 : 0.0;
    em[u] = 0.0;
  }
  const int nl3 = l_lensed_max + 1;
  for (int l = 0; l <= l_lensed_max; ++l) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (l == kM[use[u]]) e[u] = seed[use[u]];
    if (l >= 2) {
      const double d00 = e[0], d20 = e[1], d22 = e[2], d2m2 = e[3];
      double v[4];
      v[0] = ksi * d00 * w8;
      v[1] = 0.5 * (ksip * d22 + ksim * d2m2) * w8;
      v[2] = ksiX * d20 * w8;
      v[3] = 0.5 * (ksip * d22 - ksim * d2m2) * w8;
      if (!valid) v[0] = v[1] = v[2] = v[3] = 0.0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const double s = warp_sum(v[c]);
        if (lane == 0) red[c][warp] = s;
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          double s = lane < kWarps ? red[c][lane] : 0.0;
          s = warp_sum(s);
          if (lane == 0) partial[((size_t)blockIdx.x * nl3 + l) * 4 + c] = s;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const double dn = d_step(B, S, ld, use[u], l, mu, e[u], em[u]);
      em[u] = e[u];
      e[u] = dn;
    }
  }
}

// Sum the per-block partials in block order and assemble the (n, 7) table:
// lensed tt, ee, te, bb (plus the unlensed add-back in fast mode) and the
// unlensed pp, tp, ep copies.
__global__ void lensing_reduce_kernel(const double* __restrict__ partial,
                                      const double* __restrict__ cl, int nblocks,
                                      int l_lensed_max, int fast, double* __restrict__ out) {
  const int n = l_lensed_max - 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * kNct) return;
  const int row = i / kNct, col = i % kNct;
  const int l = row + 2;
  const double* c = cl + (size_t)l * kNct;
  int comp = -1;
  if (col == TT) comp = 0;
  else if (col == EE) comp = 1;
  else if (col == TE) comp = 2;
  else if (col == BB) comp = 3;
  if (comp < 0) {
    out[i] = c[col];
    return;
  }
  const int nl3 = l_lensed_max + 1;
  double s = 0.0;
  for (int b = 0; b < nblocks; ++b) s += partial[((size_t)b * nl3 + l) * 4 + comp];
  double v = 2.0 * kPi * s;
  if (fast) v = v + c[col];
  out[i] = v;
}

}  // namespace

extern "C" int lensing_wigner_launch(const void* cl, const void* w_pp, const void* sq,
                                     const void* mu, const void* w8, const void* B,
                                     const void* S, const void* seeds, int nmu, int lmax,
                                     int l_lensed_max, int fast, void* partial, void* out,
                                     void* stream) {
  if (nmu <= 0 || lmax < 4 || l_lensed_max < 2 || l_lensed_max > lmax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblocks = (nmu + kThreads - 1) / kThreads;
  lensing_passes_kernel<<<nblocks, kThreads, 0, st>>>(
      (const double*)cl, (const double*)w_pp, (const double*)sq, (const double*)mu,
      (const double*)w8, (const double*)B, (const double*)S, (const double*)seeds, nmu,
      lmax, l_lensed_max, fast, (double*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = (l_lensed_max - 1) * kNct;
  lensing_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      (const double*)partial, (const double*)cl, nblocks, l_lensed_max, fast, (double*)out);
  return (int)cudaGetLastError();
}

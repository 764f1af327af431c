// HyRec-2011 recombination history, written once as plain C++ for a team of
// threads: hyrec.cu runs it on one block of ten warps (all of them fill the
// table of redshift-only quantities; the march then keeps the first warp in
// the effective 3-level model, all ten in the two-photon model),
// hyrec_host.cpp builds the same
// functions for the host with a team of one, so that the CPU tests can hold
// this arithmetic against the plain Python loop of
// classpp_public_torch/models/hyrec.py (`hyrec_history_plain`) without a card.
//
// Counterparts, line by line: hyrec.py `hubble_s`, `_chi_heat`, `_chi_ion`,
// `tm_ss`, `dtm_dlna`, the Saha functions, `helium_dxedt`,
// `interpolate_rates`, `hmla_dxedlna`, `peebles_dxedlna`, `_fplus`,
// `_diffusion_rates`, `_thomas3`, `twophoton_dxedlna` and the phase machine
// of `hyrec_history_plain`. Every `x ** y` of the Python is pow(x, y) here,
// every sum keeps the Python's order, and the per-bin sums of the two-photon
// rate are the fixed tree of `_tree_sum` (on the card: warp butterflies, then
// a 16-value tree over the warp sums), so the host build reproduces the plain
// loop up to the last bit or two; on the card the last bits of exp/pow/log
// and FMA contraction differ.

#pragma once

#include <math.h>

#include "team.cuh"

#ifdef __CUDACC__
#define HY_FN __host__ __device__ inline
#else
#define HY_FN inline
#endif

namespace hy {

using team::Team;

// hyrec/hydrogen.h:14-26, 77-80 (eV, cgs)
constexpr double EI = 13.598286071938324, E21 = 10.198714553953742;
constexpr double E31 = 12.087365397278509, E41 = 12.748393192442178;
constexpr double E32 = 1.8886508433247664, E42 = 2.5496786384884356;
constexpr double KBOLTZ = 8.617343e-5, L2S1S = 8.2206, HPC = 1.239841874331e-04;
constexpr double MH_EV = 0.93878299831e9, kPi = 3.141592653589793;
constexpr int NSUBLYA = 140, NVIRT = 311, NDIFF = 80, NSUBDIFF = NSUBLYA - NDIFF / 2;
constexpr int NDIFF_HI = NSUBLYA + NDIFF / 2;   // the diffusion window is [NSUBDIFF, NDIFF_HI)
constexpr int NSPEC = NVIRT + 2, NROW = NVIRT + 3, NTR = 100, NTM = 40, RING = 512;
constexpr int NWARP = 10;                        // the two-photon block: NWARP warps
constexpr double DLNA = 8.49e-5, TM_TR_MIN = 0.1;
constexpr double DTMTR = (1.0 - 0.1) / 39.0;
// (log(TR_MAX) - log(TR_MIN)) / (NTR - 1) and log(TR_MIN), TR in [0.004, 0.4],
// as the Python computes them with libm
constexpr double DLOGTR = 0.04651687056553627, LOG_TR_MIN = -5.521460917862246;

enum Phase { HE_SAHA, HE_POSTSAHA, HE_EVOL, H_POSTSAHA, H2G_TMSS, H2G_TM, HMLA, PEEBLES };

// The scalars of one cosmology, in the order of hyrec.py HY_PARAMS.
struct Params {
  double T0, nH0, fHe, omh2, okh2, odeh2, ogh2, onuh2_fac, w0, wa;
};
constexpr int kNParams = sizeof(Params) / sizeof(double);

// The rate tables and the photon-history read specs (HyrecTables).
struct Tables {
  const double* log_alpha;   // (2, NTM, NTR)
  const double* log_r2p2s;   // (NTR,)
  const double* twog;        // (5, NVIRT): Eb, A1s, A2s, A3s3d, A4s4d
  const int* read_src;       // (NSPEC,)
  const int* read_off;       // (NSPEC,)
  const double* read_w;      // (NSPEC, 4)
};

// What the threads of the two-photon rate share (shared memory on the card).
struct Scratch {
  double fplus[NSPEC];
  double Tvr0[NVIRT], Tvr1[NVIRT], Trv0[NVIRT], Trv1[NVIRT], ex[NVIRT];
  double Aup[NVIRT], Adn[NVIRT], Tvv0[NVIRT], sv[NVIRT], Pib[NVIRT], omemD[NVIRT];
  double inv0[NVIRT], inv1[NVIRT], invs[NVIRT], xv[NVIRT];
  double th_a[3][NDIFF], th_g[3][NDIFF];
  double part[8][NWARP];
  double A2p_up, A2p_dn;
  unsigned char thick[NVIRT];
};

HY_FN void block_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

// --- elementary pieces ------------------------------------------------------

HY_FN double hubble_s(const Params& P, double z) {
  const double ai = 1.0 + z;
  const double rho = P.omh2 * pow(ai, 3.0) + P.okh2 * pow(ai, 2.0)
                     + P.odeh2 * pow(ai, 3.0 * (1.0 + P.w0))
                           * exp(3.0 * P.wa * (log(ai) - 1.0 + 1.0 / ai))
                     + P.ogh2 * pow(ai, 4.0) * (1.0 + P.onuh2_fac);
  return 3.2407792896393e-18 * sqrt(rho);
}

HY_FN double chi_heat(double xe) {
  if (!(xe < 1.0)) return 1.0;
  const double xc = xe > 0.0 ? xe : 0.0;
  const double fit = 0.996857 * (1.0 - pow(1.0 - pow(xc, 0.300134), 1.51035));
  return fit < 1.0 ? fit : 1.0;
}

HY_FN double chi_ion(double xe) {
  if (!(xe < 1.0)) return 0.0;
  const double xc = xe > 0.0 ? xe : 0.0;
  return 0.369202 * pow(1.0 - pow(xc, 0.463929), 1.70237);
}

// tm_ss and dtm_dlna take Tr^4 (pow(Tr, 4), from the step's table row). The
// injection terms are added only when er != 0: the Python adds an exact +0
// otherwise.
HY_FN double tm_ss(double xe, double Tr, double Tr4, double H, double fHe, double nH, double er) {
  const double t = Tr / (1.0 + H / 4.91466895548409e-22 / Tr4 * (1.0 + xe + fHe) / xe);
  if (er == 0.0) return t;
  return t + 2.0 / 3.0 / KBOLTZ * chi_heat(xe) / nH * er / (4.91466895548409e-22 * Tr4 * xe);
}

HY_FN double dtm_dlna(double xe, double Tm, double Tr, double Tr4, double H, double fHe,
                      double nH, double er) {
  const double t = -2.0 * Tm + 4.91466895548409e-22 * Tr4 * xe / (1.0 + xe + fHe) * (Tr - Tm) / H;
  if (er == 0.0) return t;
  return t + 2.0 / 3.0 / KBOLTZ * chi_heat(xe) / nH * er / (1.0 + xe + fHe) / H;
}

HY_FN double saha_xe_H(const Params& P, double z) {
  const double ai = 1.0 + z;
  const double Tr = P.T0 * ai;
  const double nH = P.nH0 * pow(ai, 3.0);
  const double s = 2.4127161187130e21 * Tr * sqrt(Tr) * exp(-157801.37882 / Tr) / nH;
  return 2.0 / (1.0 + sqrt(1.0 + 4.0 / s));
}

HY_FN double saha_HeII(const Params& P, double z, double* xHeIII) {
  const double ai = 1.0 + z;
  const double Tr = P.T0 * ai;
  const double nH = P.nH0 * pow(ai, 3.0);
  const double s = 2.414194e21 * Tr * sqrt(Tr) * exp(-631462.7 / Tr) / nH;
  const double f = P.fHe;
  *xHeIII = 2.0 * s * f / (1.0 + s + f)
            / (1.0 + sqrt(1.0 + 4.0 * s * f / pow(1.0 + s + f, 2.0)));
  return 1.0 + f + *xHeIII;
}

HY_FN double saha_HeI(const Params& P, double z) {
  const double ai = 1.0 + z;
  const double Tr = P.T0 * ai;
  const double nH = P.nH0 * pow(ai, 3.0);
  const double s = 2.414194e21 * Tr * sqrt(Tr) * exp(-285325.0 / Tr) / nH * 4.0;
  const double q = 2.0 * s * P.fHe / (1.0 + s)
                   / (1.0 + sqrt(1.0 + 4.0 * s * P.fHe / pow(1.0 + s, 2.0)));
  return 1.0 + q;
}

// The redshift-only quantities of one step, a row of the history's table
// (filled in parallel before the serial march): H, n_H, T_r^4, the radiation
// terms of the Peebles rate, the HeII Saha state and the redshift-only parts
// of helium_dxedt, each computed as the Python computes it inline.
enum ZCol {
  ZH, ZNH, ZTR4, ZSQTR, ZEB, ZE21, ZXEHEII, ZXHEIII, ZSQTRK, ZEHE, ZS0, ZS, ZXHII, ZY2S, ZY2P,
  ZEETA, ZG2P, ZE2947, ZSDIFF, NZCOL
};

HY_FN void z_row(const Params& P, double z, double* r) {
  const double ai = 1.0 + z;
  const double Tr = P.T0 * ai;                 // K
  const double TR = Tr * KBOLTZ;               // eV
  const double nH = P.nH0 * pow(ai, 3.0);      // m^-3
  r[ZH] = hubble_s(P, z);
  r[ZNH] = nH;
  r[ZTR4] = pow(Tr, 4.0);
  r[ZSQTR] = sqrt(TR);
  r[ZEB] = exp(-0.25 * EI / TR);
  r[ZE21] = exp(-E21 / TR);
  double xHeIII;
  r[ZXEHEII] = saha_HeII(P, z, &xHeIII);
  r[ZXHEIII] = xHeIII;
  r[ZSQTRK] = sqrt(Tr);
  r[ZEHE] = exp(-285325.0 / Tr);
  r[ZS0] = 2.414194e21 * Tr * r[ZSQTRK] / nH * 4.0;
  r[ZS] = r[ZS0] * r[ZEHE];
  r[ZXHII] = saha_xe_H(P, z);
  r[ZY2S] = exp(46090.0 / Tr) / r[ZS0];
  r[ZY2P] = exp(39101.0 / Tr) / r[ZS0] * 3.0;
  r[ZEETA] = exp(115.920 - 157801.37882 / Tr);
  r[ZG2P] = 1.976e6 / (1.0 - exp(-6989.0 / Tr))
            + 6.03e6 / (exp(19754.0 / Tr) - 1.0)
            + 1.06e8 / (exp(21539.0 / Tr) - 1.0)
            + 2.18e6 / (exp(28496.0 / Tr) - 1.0)
            + 3.37e7 / (exp(29224.0 / Tr) - 1.0)
            + 1.04e6 / (exp(32414.0 / Tr) - 1.0)
            + 1.51e7 / (exp(32781.0 / Tr) - 1.0);
  r[ZE2947] = exp(2947.0 / Tr);
  r[ZSDIFF] = saha_xe_H(P, z - 0.5) - saha_xe_H(P, z + 0.5);
}

// HeII->I recombination rate dxe/dt (helium_dxedt) at the redshift of the
// table row r; pi2 = pow(pi, 2).
HY_FN double helium_dxedt(const Params& P, const double* r, double pi2, double xe, double H,
                          double z) {
  const double ai = 1.0 + z;
  const double Tr = P.T0 * ai;
  const double nH = r[ZNH];
  const double xHeII = xe - r[ZXHII];
  const double xHeI = P.fHe - xHeII;
  const double etacinv = H / (nH * nH * xe) * Tr * r[ZSQTRK] * r[ZEETA];
  const double tau2p = 4.277e-14 * nH / H * xHeI;
  const double dnuline = r[ZG2P] * tau2p / (4.0 * pi2);
  const double tauc = dnuline / etacinv;
  const double enh = sqrt(1.0 + pi2 * tauc) + 7.74 * tauc / (1.0 + 70.0 * tauc);
  double pesc = enh / tau2p;
  pesc = pesc + (1.0 - exp(-1.023e-7 * tau2p))
                    * (0.964525 * r[ZE2947] - enh * exp(-6.14e13 / etacinv)) / tau2p;
  const double ydown = 50.94 * r[ZY2S] + 1.7989e9 * r[ZY2P] * pesc;
  const double xdown = ydown * xHeII * xe;
  const double xup = ydown * xHeI * r[ZS];
  return xup - xdown + H * ai * r[ZSDIFF];
}

HY_FN void cubic_w(double f, double c[4]) {
  c[0] = f * (f - 1.0) * (2.0 - f) / 6.0;
  c[1] = (1.0 + f) * (1.0 - f) * (2.0 - f) / 2.0;
  c[2] = (1.0 + f) * f * (2.0 - f) / 2.0;
  c[3] = (1.0 + f) * f * (f - 1.0) / 6.0;
}

HY_FN double dot4(const double* a, const double* c) {
  return ((a[0] * c[0] + a[1] * c[1]) + a[2] * c[2]) + a[3] * c[3];
}

HY_FN int clampi(int i, int lo, int hi) { return i < lo ? lo : (i > hi ? hi : i); }

// (Alpha[2], Beta[2], R2p2s): hydrogen.c:137 interpolate_rates
HY_FN void interpolate_rates(const Tables& T, double TR, double TM_TR, double Alpha[2],
                             double Beta[2], double* R2p2s) {
  const double x1 = (TM_TR - TM_TR_MIN) / DTMTR;
  const int iTM = clampi((int)floor(x1), 1, NTM - 3);
  double c1[4], c2[4];
  cubic_w(x1 - (double)iTM, c1);
  const double x2 = (log(TR) - LOG_TR_MIN) / DLOGTR;
  const int iTR = clampi((int)floor(x2), 1, NTR - 3);
  cubic_w(x2 - (double)iTR, c2);
  for (int lev = 0; lev < 2; ++lev) {
    double temp[4];
    for (int jj = 0; jj < 4; ++jj)
      temp[jj] = dot4(T.log_alpha + (long)(lev * NTM + iTM - 1 + jj) * NTR + iTR - 1, c2);
    Alpha[lev] = exp(dot4(temp, c1));
    Beta[lev] = exp(dot4(T.log_alpha + (long)(lev * NTM + NTM - 1) * NTR + iTR - 1, c2));
  }
  const double factor = 3.016103031869581e21 * TR * sqrt(TR) * exp(-3.399571517984581 / TR);
  Beta[0] = Beta[0] * factor;
  Beta[1] = Beta[1] * (factor / 3.0);
  *R2p2s = exp(dot4(T.log_r2p2s + iTR - 1, c2));
}

HY_FN double hmla_dxedlna(const Tables& T, double xe, double nH, double H, double TM, double TR,
                          double er) {
  double Alpha[2], Beta[2], R2p2s;
  interpolate_rates(T, TR, TM / TR, Alpha, Beta, &R2p2s);
  const double x1s_db = (1.0 - xe) * exp(-E21 / TR);
  const double RLya = 4.662899067555897e15 * H / nH / (1.0 - xe);
  const double m00 = Beta[0] + 3.0 * R2p2s + L2S1S;
  const double m01 = -R2p2s;
  const double b0 = xe * xe * nH * Alpha[0] + L2S1S * x1s_db;
  const double m11 = Beta[1] + R2p2s + RLya;
  const double m10 = -3.0 * R2p2s;
  const double b1 = xe * xe * nH * Alpha[1] + 3.0 * RLya * x1s_db;
  const double det = m00 * m11 - m01 * m10;
  const double x2s = (m11 * b0 - m01 * b1) / det;
  const double x2p = (m00 * b1 - m10 * b0) / det;
  const double C_2p = (RLya + R2p2s * L2S1S / m00) / (m11 - R2p2s * 3.0 * R2p2s / m00);
  const double d = x1s_db * (L2S1S + 3.0 * RLya) - x2s * L2S1S - x2p * RLya;
  if (er == 0.0) return d / H;
  const double inj = chi_ion(xe) / nH * er * (1.0 / EI + (1.0 - C_2p) / E21);
  return (d + inj) / H;
}

// r: the table row of the radiation temperature TR (its sqrt(TR),
// exp(-EI/4TR), exp(-E21/TR))
HY_FN double peebles_dxedlna(const double* r, double xe, double nH, double H, double TM, double TR,
                             double fudge, double er) {
  const double t4 = TM / KBOLTZ / 1e4;
  const double alphaB = fudge * 4.309e-13 * pow(t4, -0.6166) / (1.0 + 0.6703 * pow(t4, 0.5300));
  const double RLya = 4.662899067555897e15 * H / nH / (1.0 - xe);
  const double four_betaB = 3.016103031869581e21 * TR * r[ZSQTR] * r[ZEB] * alphaB;
  const double C = (3.0 * RLya + L2S1S) / (3.0 * RLya + L2S1S + four_betaB);
  const double d = (-nH * xe * xe * alphaB + four_betaB * (1.0 - xe) * r[ZE21]) * C / H;
  if (er == 0.0) return d;
  const double inj = chi_ion(xe) / nH * er * (1.0 / EI + (1.0 - C) / E21);
  return d + inj / H;
}

// --- the two-photon rate (model "full") ---------------------------------------

// The NWARP partial sums of one per-bin quantity into part: on the card v is
// this thread's value (0 beyond NVIRT) and each warp reduces by butterflies
// (lane 0 of warp w, the 32-value halving tree of bins 32w..32w+31); on the
// host arr holds every bin's value and the same trees run in a loop.
HY_FN void partials(const Team& tm, double v, const double* arr, double* part) {
#ifdef __CUDA_ARCH__
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  if ((tm.tid & 31) == 0 && (tm.tid >> 5) < NWARP) part[tm.tid >> 5] = v;
#else
  (void)tm;
  (void)v;
  for (int w = 0; w < NWARP; ++w) {
    double c[32];
    for (int i = 0; i < 32; ++i) c[i] = 32 * w + i < NVIRT ? arr[32 * w + i] : 0.0;
    for (int n = 16; n > 0; n >>= 1)
      for (int i = 0; i < n; ++i) c[i] = c[i] + c[i + n];
    part[w] = c[0];
  }
#endif
}

// The halving tree over the NWARP partial sums, padded to 16.
HY_FN double combine(const double* part) {
  double c[16];
  for (int w = 0; w < 16; ++w) c[w] = w < NWARP ? part[w] : 0.0;
  for (int n = 8; n > 0; n >>= 1)
    for (int i = 0; i < n; ++i) c[i] = c[i] + c[i + n];
  return c[0];
}

// the off-diagonals of the virtual block: T_{b,b-1} and T_{b,b+1}, zero
// outside the diffusion window and across the Ly-a line
HY_FN double tvv1(const Scratch& S, int b) {
  return (b >= NSUBDIFF && b < NDIFF_HI && b != NSUBLYA) ? -S.Aup[b - 1] : 0.0;
}
HY_FN double tvv2(const Scratch& S, int b) {
  return (b >= NSUBDIFF && b < NDIFF_HI && b != NSUBLYA - 1) ? -S.Adn[b + 1] : 0.0;
}

// dxe/dlna of the full two-photon model at ring slot m (twophoton_dxedlna),
// writing the new log f^- row into slot m of the ring. Every thread of the
// team calls it and returns the same value.
HY_FN double twophoton(const Tables& T, const Team& tm, Scratch& S, double* ring, int m,
                       double xe, double nH, double H, double TM, double TR, double er) {
  const double* Eb = T.twog;
  const double* A1s = T.twog + NVIRT;
  const double* A2s = T.twog + 2 * NVIRT;
  const double* A3s3d = T.twog + 3 * NVIRT;
  const double* A4s4d = T.twog + 4 * NVIRT;
  block_sync();   // the ring rows and the scratch of the last evaluation are settled
  // photon-history reads (_fplus)
  for (int i = tm.tid; i < NSPEC; i += tm.nt) {
    const int base = m - T.read_off[i], src = T.read_src[i];
    double v[4];
    for (int k = 0; k < 4; ++k) {
      const int r = ((base - 1 + k) % RING + RING) % RING;
      v[k] = ring[(long)r * NROW + src];
    }
    S.fplus[i] = exp(dot4(v, T.read_w + 4 * i));
  }
  double Alpha[2], Beta[2], R2p2s;
  interpolate_rates(T, TR, TM / TR, Alpha, Beta, &R2p2s);
  const double RLya = 4.662899067555897e15 * H / nH / (1.0 - xe);
  const double e32 = exp(-E32 / TR), e42 = exp(-E42 / TR);
  // the virtual-real rows, and the wing exponentials of the diffusion rates
  double t0 = 0.0, t1 = 0.0;
  for (int b = tm.tid; b < NVIRT; b += tm.nt) {
    const double dbfact = exp((Eb[b] - E21) / TR);
    t0 = -A2s[b] / fabs(dbfact - 1.0);
    t1 = -e32 / 3.0 * A3s3d[b] / fabs(exp((Eb[b] - E31) / TR) - 1.0)
         - e42 / 3.0 * A4s4d[b] / fabs(exp((Eb[b] - E41) / TR) - 1.0);
    S.Tvr0[b] = t0;
    S.Trv0[b] = t0 * dbfact;
    S.Tvr1[b] = t1;
    S.Trv1[b] = t1 * 3.0 * dbfact;
    if (b > NSUBDIFF && b < NSUBLYA) S.ex[b] = exp((Eb[b] - Eb[b - 1]) / TM);
    else if (b >= NSUBLYA && b < NDIFF_HI - 1) S.ex[b] = exp(-(Eb[b + 1] - Eb[b]) / TM);
  }
  // sums of the rows before the Ly-a corrections
  partials(tm, t0, S.Tvr0, S.part[0]);
  partials(tm, t1, S.Tvr1, S.part[1]);
  block_sync();
  // the two wing recurrences (_diffusion_rates), one thread each
  const double DE2 = E21 * E21 * 2.0 * TM / MH_EV;
  if (tm.tid == 0) {
    const double d = Eb[NSUBDIFF + 1] - Eb[NSUBDIFF];
    double aup = DE2 / (d * d) * A1s[NSUBDIFF];
    S.Aup[NSUBDIFF] = aup;
    for (int b = NSUBDIFF + 1; b < NSUBLYA; ++b) {
      const double dEdn = Eb[b] - Eb[b - 1];
      const double dEup = b < NSUBLYA - 1 ? Eb[b + 1] - Eb[b] : E21 - Eb[b];
      const double adn = S.ex[b] * aup;
      aup = (DE2 * A1s[b] - dEdn * dEdn * adn) / (dEup * dEup);
      S.Aup[b] = aup;
      S.Adn[b] = adn;
    }
    S.A2p_dn = exp((E21 - Eb[NSUBLYA - 1]) / TM) / 3.0 * aup;
  }
  if (tm.tid == (tm.nt > 1 ? 1 : 0)) {
    const int b1 = NDIFF_HI - 1;
    const double d = Eb[b1] - Eb[b1 - 1];
    double adn = DE2 / (d * d) * A1s[b1];
    S.Adn[b1] = adn;
    for (int b = b1 - 1; b >= NSUBLYA; --b) {
      const double dEup = Eb[b + 1] - Eb[b];
      const double dEdn = b > NSUBLYA ? Eb[b] - Eb[b - 1] : Eb[b] - E21;
      const double aup = S.ex[b] * adn;
      adn = (DE2 * A1s[b] - dEup * dEup * aup) / (dEdn * dEdn);
      S.Aup[b] = aup;
      S.Adn[b] = adn;
    }
    S.A2p_up = exp((E21 - Eb[NSUBLYA]) / TM) / 3.0 * adn;
  }
  block_sync();
  // Gamma_b (from the rows before the Ly-a-neighbour corrections,
  // hydrogen.c:457), the corrections, optical depths and the sources
  for (int b = tm.tid; b < NVIRT; b += tm.nt) {
    const double gamma = -(S.Trv0[b] + S.Trv1[b]) + S.Aup[b] + S.Adn[b];
    if (b == NSUBLYA - 1) {
      S.Tvr1[b] = S.Tvr1[b] - S.A2p_dn;
      S.Trv1[b] = S.Trv1[b] - S.Aup[b];
    } else if (b == NSUBLYA) {
      S.Tvr1[b] = S.Tvr1[b] - S.A2p_up;
      S.Trv1[b] = S.Trv1[b] - S.Adn[b];
    }
    const double dtau = gamma * (1.0 - xe) * pow(HPC / Eb[b], 3.0) * nH / 8.0 / kPi / H;
    const bool th = dtau > 1e-30;
    const double Dt = th ? dtau : 1.0;
    const double omemD = 1.0 - exp(-Dt);
    const double Pib = omemD / Dt;
    S.thick[b] = th;
    S.omemD[b] = omemD;
    S.Pib[b] = Pib;
    if (th) {
      S.Tvv0[b] = gamma / (1.0 - Pib);
      S.sv[b] = S.Tvv0[b] * (1.0 - xe) * S.fplus[b] * Pib;
    } else {
      S.Tvv0[b] = 1.0;
      S.Trv0[b] = S.Trv1[b] = S.Tvr0[b] = S.Tvr1[b] = 0.0;
      S.sv[b] = (1.0 - xe) * S.fplus[b];
    }
  }
  block_sync();
  // the diffusion window: a Thomas solve per right-hand side, one thread each
  for (int r = tm.tid; r < 3; r += tm.nt) {
    const double* rhs = r == 0 ? S.Tvr0 : (r == 1 ? S.Tvr1 : S.sv);
    double* x = r == 0 ? S.inv0 : (r == 1 ? S.inv1 : S.invs);
    double ap = 0.0, gp = 0.0;
    for (int i = 0; i < NDIFF; ++i) {
      const int b = NSUBDIFF + i;
      const double l = tvv1(S, b);
      const double denom = S.Tvv0[b] - l * ap;
      ap = tvv2(S, b) / denom;
      gp = (rhs[b] - l * gp) / denom;
      S.th_a[r][i] = ap;
      S.th_g[r][i] = gp;
    }
    double xn = 0.0;
    for (int i = NDIFF - 1; i >= 0; --i) {
      xn = S.th_g[r][i] - S.th_a[r][i] * xn;
      x[NSUBDIFF + i] = xn;
    }
  }
  // and the diagonal elsewhere
  for (int b = tm.tid; b < NVIRT; b += tm.nt) {
    if (b >= NSUBDIFF && b < NSUBDIFF + NDIFF) continue;
    S.inv0[b] = S.Tvr0[b] / S.Tvv0[b];
    S.inv1[b] = S.Tvr1[b] / S.Tvv0[b];
    S.invs[b] = S.sv[b] / S.Tvv0[b];
  }
  block_sync();
  // the Schur-complement sums
#ifdef __CUDA_ARCH__
  {
    const int b = tm.tid;
    const bool in = b < NVIRT;
    partials(tm, in ? S.Trv0[b] * S.inv0[b] : 0.0, nullptr, S.part[2]);
    partials(tm, in ? S.Trv0[b] * S.inv1[b] : 0.0, nullptr, S.part[3]);
    partials(tm, in ? S.Trv1[b] * S.inv0[b] : 0.0, nullptr, S.part[4]);
    partials(tm, in ? S.Trv1[b] * S.inv1[b] : 0.0, nullptr, S.part[5]);
    partials(tm, in ? S.Trv0[b] * S.invs[b] : 0.0, nullptr, S.part[6]);
    partials(tm, in ? S.Trv1[b] * S.invs[b] : 0.0, nullptr, S.part[7]);
  }
#else
  {
    const double* rows[6] = {S.Trv0, S.Trv0, S.Trv1, S.Trv1, S.Trv0, S.Trv1};
    const double* cols[6] = {S.inv0, S.inv1, S.inv0, S.inv1, S.invs, S.invs};
    for (int k = 0; k < 6; ++k) {
      double arr[NVIRT];
      for (int b = 0; b < NVIRT; ++b) arr[b] = rows[k][b] * cols[k][b];
      partials(tm, 0.0, arr, S.part[2 + k]);
    }
  }
#endif
  block_sync();
  double s[8];
  for (int k = 0; k < 8; ++k) s[k] = combine(S.part[k]);
  const double fLy0 = S.fplus[NVIRT], fLy1 = S.fplus[NVIRT + 1];
  const double Trr00 = Beta[0] + 3.0 * R2p2s + 3.0 * RLya * (1.664786871919931 * e32 + 1.953125 * e42);
  const double Trr01 = -R2p2s;
  const double sr0 = nH * Alpha[0] * xe * xe
                     + 3.0 * RLya * (1.0 - xe) * (1.664786871919931 * fLy1 + 1.953125 * exp(-E41 / TR));
  const double Trr11 = Beta[1] + R2p2s + RLya;
  const double Trr10 = -3.0 * R2p2s;
  const double sr1 = nH * Alpha[1] * xe * xe + 3.0 * RLya * (1.0 - xe) * fLy0;
  const double Trr_new00 = (Trr00 - s[0]) - s[2];
  const double Trr_new01 = Trr01 - s[3];
  const double Trr_new10 = Trr10 - s[4];
  const double Trr_new11 = ((Trr11 - s[1]) + S.A2p_dn + S.A2p_up) - s[5];
  const double sr_new0 = sr0 - s[6];
  const double sr_new1 = sr1 - s[7];
  const double det = Trr_new00 * Trr_new11 - Trr_new01 * Trr_new10;
  const double xr0 = (Trr_new11 * sr_new0 - Trr_new01 * sr_new1) / det;
  const double xr1 = (Trr_new00 * sr_new1 - Trr_new10 * sr_new0) / det;
  for (int b = tm.tid; b < NVIRT; b += tm.nt) S.xv[b] = S.invs[b] - S.inv0[b] * xr0 - S.inv1[b] * xr1;
  // DM injection (hydrogen.c:714-727): C_2p from the base 2x2 blocks
  const double m00 = Beta[0] + 3.0 * R2p2s + L2S1S;
  const double C_2p = (RLya + R2p2s * L2S1S / m00)
                      / (Beta[1] + R2p2s + RLya - R2p2s * 3.0 * R2p2s / m00);
  double xedot = -nH * xe * xe * (Alpha[0] + Alpha[1]) + xr0 * Beta[0] + xr1 * Beta[1];
  if (er != 0.0) xedot = xedot + chi_ion(xe) / nH * er * (1.0 / EI + (1.0 - C_2p) / E21);
  block_sync();
  // the new f^- row (hydrogen.c:730-749)
  double* row = ring + (long)(m % RING) * NROW;
  for (int b = tm.tid; b < NVIRT; b += tm.nt) {
    double arg = S.fplus[b];
    if (S.thick[b]) {
      const double xv_up = b + 1 < NVIRT ? S.xv[b + 1] : 0.0;
      const double xv_dn = b > 0 ? S.xv[b - 1] : 0.0;
      double feq = -xr0 * S.Tvr0[b] - xr1 * S.Tvr1[b] - (xv_up * tvv2(S, b) + xv_dn * tvv1(S, b));
      feq = feq / ((1.0 - xe) * (1.0 - S.Pib[b]) * S.Tvv0[b]);
      arg = S.fplus[b] + (feq - S.fplus[b]) * S.omemD[b];
    }
    row[b] = log(arg);
  }
  if (tm.tid == 0) {
    const double lr0 = log(xr0 / (1.0 - xe));
    row[NVIRT] = log(xr1 / 3.0 / (1.0 - xe));
    row[NVIRT + 1] = lr0 - E32 / TR;
    row[NVIRT + 2] = lr0 - E42 / TR;
  }
  return xedot / H;
}

// --- the staged history (hyrec_history_plain) ---------------------------------

// xe, Tm (nz,) on the descending grid z, written by thread 0. inj: the
// injection rate per slot or null; full: the two-photon model (ring: the
// (RING, NROW) photon history, every entry -1 at the start; S: the team's
// scratch), else the effective 3-level model (ring and S unused). zt:
// (nz, NZCOL) scratch for the redshift-only table, filled by the whole team
// first; in the 3-level model only the first warp (the first thread on the
// host) then runs the march, the two-photon rate needs the whole team.
HY_FN void history(const Params& P, const Tables& T, const Team& tm, const double* z, int nz,
                   const double* inj, bool full, double* ring, Scratch* S, double* zt,
                   double* xe_out, double* Tm_out) {
  for (int j = tm.tid; j < nz; j += tm.nt) z_row(P, z[j], zt + (long)j * NZCOL);
  if (full)
    for (int b = tm.tid; b < NVIRT; b += tm.nt) S->Aup[b] = S->Adn[b] = 0.0;
  block_sync();
  if (!full && tm.tid >= 32) return;
  const double T0 = P.T0, fHe = P.fHe;
  const double pi2 = pow(kPi, 2.0);
  const double* Eb = T.twog;
  double xe = zt[ZXEHEII];
  double Tm = T0 * (1.0 + z[0]);
  if (tm.tid == 0) {
    xe_out[0] = xe;
    Tm_out[0] = Tm;
  }
  int phase = HE_SAHA;
  double dxe_p = 0.0, dxe_p2 = 0.0, dTm_p = 0.0, dTm_p2 = 0.0;
  for (int j = 1; j < nz; ++j) {
    const double* r = zt + (long)j * NZCOL;        // this step's row
    const double* rp = r - NZCOL;                  // the step before
    const double zj = z[j], zp = z[j - 1];
    const double ai = 1.0 + zj;
    const double Tr_K = T0 * ai;
    const double H = r[ZH];
    const double nH_cm = r[ZNH] * 1e-6;
    const double Tr_eV = Tr_K * KBOLTZ;
    const double aip = 1.0 + zp;
    const double Hp = rp[ZH];
    const double nHp_cm = rp[ZNH] * 1e-6;
    const double Trp_K = T0 * aip;
    const double Trp_eV = Trp_K * KBOLTZ;
    const double er = inj ? inj[j] : 0.0;
    const double erp = inj ? inj[j - 1] : 0.0;
    double xe_new, Tm_new, dxe = 0.0, dxe_n, dxe_n2, dTm_n, dTm_n2;
    bool done;
    if (phase <= H2G_TMSS) {
      // no Tm evolution yet: the Tm derivative history is primed with the
      // current steady-state derivative
      if (phase == HE_SAHA) {
        xe_new = r[ZXEHEII];
        Tm_new = Tr_K;
        done = r[ZXHEIII] <= 1e-9;
      } else if (phase == HE_POSTSAHA) {
        const double xeS = saha_HeI(P, zj);
        const double s = 2.414194e21 * Tr_K * r[ZSQTRK] * r[ZEHE] / r[ZNH] * 4.0;
        const double dxeSdt = -xeS * (xeS - 1.0) / (2.0 * xeS + s - 1.0)
                              * (285325.0 / Tr_K - 1.5) * H;
        const double Dxe = 0.01 * (1.0 + fHe - xeS);
        const double dd = (helium_dxedt(P, r, pi2, xeS + Dxe, H, zj)
                           - helium_dxedt(P, r, pi2, xeS - Dxe, H, zj)) / (2.0 * Dxe);
        const double delta = dxeSdt / dd;
        xe_new = xeS + delta;
        Tm_new = Tr_K;
        done = delta >= 5e-4;
      } else if (phase == HE_EVOL) {
        dxe = helium_dxedt(P, rp, pi2, xe, Hp, zp) / Hp;
        xe_new = xe + DLNA * (1.25 * dxe - 0.25 * dxe_p2);
        Tm_new = tm_ss(xe_new, Tr_K, r[ZTR4], H, fHe, nH_cm, er);
        done = fabs(xe_new - r[ZXHII]) <= 1e-4 && zj <= 1650.0;
      } else if (phase == H_POSTSAHA) {
        const double s = 2.4127161187130e21 * Tr_K * r[ZSQTRK] * exp(-157801.37882 / Tr_K)
                         / r[ZNH];
        const double xeS = 2.0 / (1.0 + sqrt(1.0 + 4.0 / s));
        const double dxeS = -(EI / Tr_eV - 1.5) / (2.0 * xeS + s) * xeS * xeS;
        const double eps = 0.01 * (1.0 - xeS);
        double d_hi, d_lo;
        if (full) {
          d_hi = twophoton(T, tm, *S, ring, j, xeS + eps, nH_cm, H, Tr_eV, Tr_eV, er);
          d_lo = twophoton(T, tm, *S, ring, j, xeS - eps, nH_cm, H, Tr_eV, Tr_eV, er);
        } else {
          d_hi = peebles_dxedlna(r, xeS + eps, nH_cm, H, Tr_eV, Tr_eV, 1.14, er);
          d_lo = peebles_dxedlna(r, xeS - eps, nH_cm, H, Tr_eV, Tr_eV, 1.14, er);
        }
        const double delta = dxeS / ((d_hi - d_lo) / (2.0 * eps));
        xe_new = xeS + delta;
        Tm_new = tm_ss(xe_new, Tr_K, r[ZTR4], H, fHe, nH_cm, er);
        done = delta >= 5e-5;
      } else {                                          // H2G_TMSS
        const double Tmp = tm_ss(xe, Trp_K, rp[ZTR4], Hp, fHe, nHp_cm, erp);
        dxe = full ? twophoton(T, tm, *S, ring, j - 1, xe, nHp_cm, Hp, Tmp * KBOLTZ, Trp_eV, erp)
                   : peebles_dxedlna(rp, xe, nHp_cm, Hp, Tmp * KBOLTZ, Trp_eV, 1.14, erp);
        xe_new = xe + DLNA * (1.25 * dxe - 0.25 * dxe_p2);
        Tm_new = tm_ss(xe_new, Tr_K, r[ZTR4], H, fHe, nH_cm, er);
        done = 1.0 - Tm_new / Tr_K >= 5e-4 || zj <= 700.0;
      }
      if (full && phase < H_POSTSAHA) {                // the thermal photon row
        double* row = ring + (long)(j % RING) * NROW;
        for (int c = tm.tid; c < NROW; c += tm.nt) {
          const double lev = c < NVIRT ? Eb[c] : (c == NVIRT ? E21 : (c == NVIRT + 1 ? E31 : E41));
          row[c] = -lev / Tr_eV;
        }
      }
      if (phase == HE_EVOL || phase == H2G_TMSS) {
        dxe_n = dxe;
        dxe_n2 = dxe_p;
      } else {   // the AB2 history seeded by a finite difference (history.c:281-287)
        dxe_n = (xe_new - xe) / DLNA;
        dxe_n2 = dxe_p;
      }
      dTm_n = dtm_dlna(xe_new, Tm_new, Tr_K, r[ZTR4], H, fHe, nH_cm, er);
      dTm_n2 = dTm_p;
    } else {
      const double TM = Tm * KBOLTZ;
      if (phase == H2G_TM) {
        dxe = full ? twophoton(T, tm, *S, ring, j - 1, xe, nHp_cm, Hp, TM, Trp_eV, erp)
                   : peebles_dxedlna(rp, xe, nHp_cm, Hp, TM, Trp_eV, 1.14, erp);
        done = zj <= 700.0;
      } else if (phase == HMLA) {
        dxe = full ? hmla_dxedlna(T, xe, nHp_cm, Hp, TM, Trp_eV, erp)
                   : peebles_dxedlna(rp, xe, nHp_cm, Hp, TM, Trp_eV, 1.14, erp);
        done = zj <= 20.0;
      } else {
        dxe = peebles_dxedlna(rp, xe, nHp_cm, Hp, TM, Trp_eV, full ? 1.0 : 1.14, erp);
        done = false;
      }
      const double dTm = dtm_dlna(xe, Tm, Trp_K, rp[ZTR4], Hp, fHe, nHp_cm, erp);
      xe_new = xe + DLNA * (1.25 * dxe - 0.25 * dxe_p2);
      Tm_new = Tm + DLNA * (1.25 * dTm - 0.25 * dTm_p2);
      dxe_n = dxe;
      dxe_n2 = dxe_p;
      dTm_n = dTm;
      dTm_n2 = dTm_p;
    }
    if (done && phase < PEEBLES) ++phase;
    xe = xe_new;
    Tm = Tm_new;
    dxe_p = dxe_n;
    dxe_p2 = dxe_n2;
    dTm_p = dTm_n;
    dTm_p2 = dTm_n2;
    if (tm.tid == 0) {
      xe_out[j] = xe;
      Tm_out[j] = Tm;
    }
  }
}

}  // namespace hy

// Host build of the RECFAST history and the baryon-temperature march
// (recfast.cuh): the functions recfast.cu runs on the card, here on the CPU,
// so that their arithmetic can be held against the plain Python loops on a
// machine with no card and no nvcc:
//
//   g++ -O2 -std=c++17 -shared -fPIC -o librecfast_host.so recfast_host.cpp
//
// The arguments are those of recfast_history_launch and tb_march_launch
// (recfast.cu) with host pointers and without the stream. The package never
// loads this library; tests/test_torch_background_thermo.py and
// tests/test_torch_thermo_variants.py do.

#include "recfast.cuh"

extern "C" int recfast_n_params() { return rf::kNParams; }

// the history with the ln E spline of the injection beyond the spot (Ey, Ey2
// (En, 1); null when params' inj_bos is not set)
extern "C" int recfast_history_host_inj(const double* params, const double* Hy,
                                        const double* Hy2, double Hx0, double Hdx, int Hn,
                                        const double* Ey, const double* Ey2, double Ex0,
                                        double Edx, int En, int Nz, double* out) {
  rf::Params P;
  double* pp = reinterpret_cast<double*>(&P);
  for (int i = 0; i < rf::kNParams; ++i) pp[i] = params[i];
  const rf::Hubble S{Hy, Hy2, Hx0, Hdx, Hn, Ey, Ey2, Ex0, Edx, En};
  if (P.inj_on != 0.0)
    rf::history<true>(P, S, rf::Team{0, 1}, Nz, out);
  else
    rf::history<false>(P, S, rf::Team{0, 1}, Nz, out);
  return 0;
}

// the same without the spline
extern "C" int recfast_history_host(const double* params, const double* Hy, const double* Hy2,
                                    double Hx0, double Hdx, int Hn, int Nz, double* out) {
  return recfast_history_host_inj(params, Hy, Hy2, Hx0, Hdx, Hn, nullptr, nullptr, 0.0, 0.0, 0,
                                  Nz, out);
}

extern "C" int tb_march_host(const double* z, const double* xe, const double* H,
                             const double* rho_g, const double* rho_b, const double* consts,
                             int n, double Tb_start, int idx_start, double* Tb, double* dTdz) {
  const rf::March M{z, xe, H, rho_g, rho_b, consts[0], consts[1], consts[2], consts[3],
                    consts[4], consts[5], n};
  rf::tb_march(M, Tb_start, idx_start, Tb);
  for (int i = 0; i < n; ++i) dTdz[i] = rf::tb_dTdz(M, i, Tb[i]);
  return 0;
}

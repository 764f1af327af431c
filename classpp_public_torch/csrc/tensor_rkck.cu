// Tensor-mode perturbation integrator: every k mode (lane) integrated from
// its initial time through all source sampling times by adaptive Cash-Karp
// RK4(5) steps, with the switch-time clipping, the tight-coupling-off and
// radiation-streaming remaps and the (S_T2, S_P) emission, in ONE launch.
//
// Replaces classpp_public_tpu/models/perturbations/tensors.py
// `get_tensor_solver` (:384-400, the jitted vmap of `solve_one_k` :321-381,
// exported under "pt_tensor"), whose plain PyTorch version is
// `tensor_rkck_plain` in classpp_public_torch/models/perturbations/tensors.py.
// The per-lane program is tensor_rkck.cuh.
//
// Design: one lane per warp, one warp per block. Each lane runs its own loop
// over its sample intervals: no lockstep between lanes, no host reads. The
// state (32 doubles with the default hierarchies: gw, gw', six photon
// temperature and six polarization moments, eighteen neutrino moments), the
// six stage derivatives and the stage state (9 n doubles, 2.3 KB) sit in the
// block's shared memory; the 32 threads share every loop over components,
// read one table column each per stage time, and reduce the error ratio
// with an xor butterfly (fixed order, the same bits in every thread). What
// bounds it on an H100: latency. ~400 lanes are ~400 warps, and the launch
// lasts as long as the slowest lane's serial chain of steps; within a step the
// chain is six stages of (one table read, one coupling per component).
//
// A lane whose interval runs past max_interval_steps sets its status word;
// the wrapper reads the words once and raises.

#include <cuda_runtime.h>

#include "tensor_rkck.cuh"

namespace {

constexpr int kWarp = 32;

__global__ void __launch_bounds__(kWarp)
tensor_rkck_kernel(tk::Layout L, tk::Tables T,
                   const double* __restrict__ lanes,   // (4, nl): k, tau_ini, t_tca, t_rsa
                   const double* __restrict__ taus,    // (ntau,)
                   double rtol, double K, int sgnK, long max_interval_steps, int nlanes,
                   int ntau,
                   double* __restrict__ S,             // (nl, ntau, 2)
                   long long* __restrict__ nsteps,     // (nl,)
                   int* __restrict__ status) {         // (nl,)
  extern __shared__ double work[];                     // work_doubles(L)
  const int lane = blockIdx.x;
  const tk::Team tm{(int)threadIdx.x, kWarp};
  tk::Lane ln;
  ln.k = lanes[lane];
  const double tau_ini = lanes[nlanes + lane];
  ln.t_tca = lanes[2 * nlanes + lane];
  ln.t_rsa = lanes[3 * nlanes + lane];
  ln.K = K;
  ln.sgnK = sgnK;
  ln.sl = nullptr;
  long long steps = 0;
  const int st = tk::integrate_lane(L, T, tm, ln, tau_ini, taus, ntau, rtol,
                                    max_interval_steps, work, S + 2L * lane * ntau, &steps);
  if (tm.tid == 0) {
    nsteps[lane] = steps;
    status[lane] = st;
  }
}

}  // namespace

// layout: kLayoutInts host ints in tk::Layout order. K: the spatial
// curvature in 1/Mpc^2, sgnK its sign. Every other pointer is a device
// pointer.
extern "C" int tensor_rkck_launch(const int* layout, const double* lanes, const double* taus,
                                  const double* bg_y, const double* bg_y2, double bg_x0,
                                  double bg_dx, int bg_n, const double* th_y,
                                  const double* th_y2, double th_x0, double th_dx, int th_n,
                                  double rtol, double K, int sgnK, long long max_interval_steps,
                                  int nlanes, int ntau, double* S, long long* nsteps,
                                  int* status, void* stream) {
  tk::Layout L;
  int* li = reinterpret_cast<int*>(&L);
  for (int i = 0; i < tk::kLayoutInts; ++i) li[i] = layout[i];
  const size_t smem = (size_t)tk::work_doubles(L) * sizeof(double);
  if (nlanes < 1 || L.nF < 5 || L.nG < 5 || (L.nU != 0 && L.nU < 5)
      || tk::kNBg + L.ns + tk::kNTh > tk::kFrameCols || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  tk::Tables T;
  T.bg_y = bg_y; T.bg_y2 = bg_y2; T.bg_x0 = bg_x0; T.bg_dx = bg_dx; T.bg_n = bg_n;
  T.bg_ncol = tk::kNBg + L.ns;
  T.th_y = th_y; T.th_y2 = th_y2; T.th_x0 = th_x0; T.th_dx = th_dx; T.th_n = th_n;
  tensor_rkck_kernel<<<nlanes, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      L, T, lanes, taus, rtol, K, sgnK, (long)max_interval_steps, nlanes, ntau, S, nsteps,
      status);
  return (int)cudaGetLastError();
}

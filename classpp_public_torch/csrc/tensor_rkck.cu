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
// temperature and six polarization moments, eighteen neutrino moments; under
// tensor method exact 16 q x 18 l = 288 more for each massive species), the
// six stage derivatives and the stage state (9 n doubles: 2.3 KB, 23 KB with
// one exact species, 65 KB with three) sit in the block's dynamic shared
// memory, sized from the layout (past 48 KB the launcher raises the kernel's
// limit; past the 227 KB a block can hold it refuses, and before that the
// wrapper, tensors.py `check_lane_scratch`, which names N_ncdm); the 32
// threads share every loop over components, read one table column each per
// stage time, and reduce the error ratio with an xor butterfly (fixed order,
// the same bits in every thread); the exact species' stress sums over q the
// same way, one species after another. What bounds it on an H100: latency.
// ~400 lanes are ~400 warps, and the launch lasts as long as the slowest
// lane's serial chain of steps; within a step the chain is six stages of (one
// table read, one coupling per component).
//
// A lane whose interval runs past max_interval_steps sets its status word;
// the wrapper reads the words once and raises.

#include <cuda_runtime.h>

#include "tensor_rkck.cuh"

namespace {

constexpr int kWarp = 32;

template <bool kExact>
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
  const int st = tk::integrate_lane<kExact>(L, T, tm, ln, tau_ini, taus, ntau, rtol,
                                            max_interval_steps, work, S + 2L * lane * ntau,
                                            &steps);
  if (tm.tid == 0) {
    nsteps[lane] = steps;
    status[lane] = st;
  }
}

// One launch of the kernel instance for kExact: its shared-memory limit
// raised past the default 48 KB when the lane scratch needs it.
template <bool kExact>
cudaError_t launch(const tk::Layout& L, const tk::Tables& T, size_t smem, const double* lanes,
                   const double* taus, double rtol, double K, int sgnK, long max_interval_steps,
                   int nlanes, int ntau, double* S, long long* nsteps, int* status,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tensor_rkck_kernel<kExact>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  tensor_rkck_kernel<kExact><<<nlanes, kWarp, smem, stream>>>(
      L, T, lanes, taus, rtol, K, sgnK, max_interval_steps, nlanes, ntau, S, nsteps, status);
  return cudaGetLastError();
}

}  // namespace

// layout: kLayoutInts host ints in tk::Layout order. ncdm: the exact
// species' q (nq), w (nsx, nq), dlnf0 (nsx, nq), x_fac (nsx), pref (nsx)
// packed in this order (null when nsx = 0). K: the spatial curvature in
// 1/Mpc^2, sgnK its sign. Every other pointer is a device pointer.
extern "C" int tensor_rkck_launch(const int* layout, const double* lanes, const double* taus,
                                  const double* bg_y, const double* bg_y2, double bg_x0,
                                  double bg_dx, int bg_n, const double* th_y,
                                  const double* th_y2, double th_x0, double th_dx, int th_n,
                                  const double* ncdm, double rtol, double K, int sgnK,
                                  long long max_interval_steps, int nlanes, int ntau, double* S,
                                  long long* nsteps, int* status, void* stream) {
  tk::Layout L;
  int* li = reinterpret_cast<int*>(&L);
  for (int i = 0; i < tk::kLayoutInts; ++i) li[i] = layout[i];
  const size_t smem = (size_t)tk::work_doubles(L) * sizeof(double);
  if (nlanes < 1 || L.nF < 5 || L.nG < 5 || (L.nU != 0 && L.nU < 5)
      || tk::kNBg + L.ns + tk::kNTh > tk::kFrameCols || smem > 232448
      || (L.nsx && (ncdm == nullptr || L.nq < 1 || L.nl < 5)))
    return (int)cudaErrorInvalidValue;
  tk::Tables T;
  T.bg_y = bg_y; T.bg_y2 = bg_y2; T.bg_x0 = bg_x0; T.bg_dx = bg_dx; T.bg_n = bg_n;
  T.bg_ncol = tk::kNBg + L.ns;
  T.th_y = th_y; T.th_y2 = th_y2; T.th_x0 = th_x0; T.th_dx = th_dx; T.th_n = th_n;
  tk::set_ncdm(T, L, L.nsx ? ncdm : nullptr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(L.nsx ? launch<true>(L, T, smem, lanes, taus, rtol, K, sgnK,
                                    (long)max_interval_steps, nlanes, ntau, S, nsteps, status, st)
                     : launch<false>(L, T, smem, lanes, taus, rtol, K, sgnK,
                                     (long)max_interval_steps, nlanes, ntau, S, nsteps, status, st));
}

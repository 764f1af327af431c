// Scalar perturbation integrator: every k mode (lane) integrated from its
// initial time through all source sampling times by adaptive IMEX
// ARK4(3)6L[2]SA steps, with the approximation-switch clipping and remaps and
// the source emission, in ONE launch.
//
// Replaces the jitted solver heads of
// classpp_public_tpu/models/perturbations/solve.py (`_stepper` :198-314,
// `solve_one_k` :317, the init/advance/emit/window heads :151,172,410,426,442),
// whose plain PyTorch version is `integrate_sources_plain` in
// classpp_public_torch/models/perturbations/solve.py. The per-lane program
// itself is perturb_ark.cuh. The gauge picks the kernel's instance: the JAX
// package compiles one solver head per PtIdx, whose `gauge` is static, and
// here `gauge` (0 synchronous, 1 Newtonian) selects perturb_ark_kernel<false>
// or <true>; the synchronous instance is the code it was before the Newtonian
// one was added. Each lane has its initial condition (`ic`, 0 adiabatic, 1 bi,
// 2 cdi, 3 nid, 4 niv; null: all adiabatic): the JAX package runs one solve
// per initial condition (solve.py:739-750), here the lanes of every initial
// condition go in one launch, and only the first state of a lane depends on
// it (perturb_ark.cuh isocurvature_ic). A layout with a scalar field
// (Layout::phi_scf >= 0, synchronous gauge only) selects the third instance,
// perturb_ark_kernel<false, true>, whose scf terms the other two do not
// compile. A layout with interacting dark matter and dark radiation
// (the layout's idm int >= 0, synchronous gauge only, without a scalar field) selects
// the fourth, perturb_ark_kernel<false, false, true>: its implicit range runs
// to the end of the idr block (n_stiff), and the idr damping's alpha_l,
// beta_l follow the ncdm data in the `ncdm` buffer.
//
// Design: one lane per warp, one warp per block. Each lane runs its own
// while loop to its last sample: no lockstep between lanes, no host reads, no
// state table. The state, the six explicit and six implicit stage vectors and
// the step's scratch (9 n + 7 n_stiff doubles per lane; n = 46 without massive
// neutrinos, 334 with one species on 16 momenta: 4 KB and 25 KB) live in the
// block's shared memory. The 32 threads share every loop over state
// components, hierarchy moments and momenta, and each reads one column of the
// two table splines per stage time; the scalar Einstein and
// tight-coupling block and the step control are computed by every thread, so
// all branches are uniform; the ncdm momentum sums and the error ratio are
// xor-butterfly reductions over the warp, whose order is fixed (no atomics)
// and which leave the same bits in every thread. What bounds it on an H100:
// latency, not bytes or operations. A few hundred lanes are a few hundred
// warps (4-5 per SM), and the launch lasts as long as the slowest lane's
// serial chain of steps (3500 on planck_row2; 32 000 on the k = 20/Mpc lane
// of a run with massive neutrinos, whose fluid keeps oscillating); within a
// step the dependent chain is the scalar block of each of the six stages.
//
// Block b integrates lane order[b] (null: lane b). The wrapper orders the
// blocks by decreasing k: with several initial conditions there are more
// lanes than resident blocks (25 KB of shared memory a lane with one ncdm
// species: ~9 blocks an SM, ~1200 on the card), and the highest-k lanes, the
// slowest of every initial condition, must start in the first wave, not
// after it.
//
// A lane that runs past max_steps or cannot produce a finite step sets its
// status word (1, 2); the wrapper reads the words once and raises.

#include <cuda_runtime.h>

#include "perturb_ark.cuh"

#ifdef PK_PROFILE
// section cycles of the last lane (the highest k) of the latest launch
__device__ long long g_profile[pk::kProfSections];
extern "C" int perturb_ark_profile(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_profile, sizeof(long long) * pk::kProfSections);
}
#define PK_PROFILE_OUT(lane, nlanes) ((lane) == (nlanes) - 1 ? g_profile : nullptr)
#else
#define PK_PROFILE_OUT(lane, nlanes) nullptr
#endif

namespace {

constexpr int kWarp = 32;

template <bool kNewt, bool kScf, bool kIdm>
__global__ void __launch_bounds__(kWarp)
perturb_ark_kernel(pk::LayoutOf<kIdm> L, pk::TablesOf<kIdm> T,
                   const double* __restrict__ lanes,  // (6, nl): k, tau_ini, t_tca, t_ufa, t_rsa, t_ncfa
                   const double* __restrict__ taus,   // (ntau,)
                   const double* __restrict__ rtol,   // (nl, n)
                   const double* __restrict__ atol,   // (nl, n)
                   const int* __restrict__ ic,        // (nl,) or null
                   const int* __restrict__ order,     // (nl,) or null
                   double k_eta_split, double K, int sgnK, long max_steps, int nlanes,
                   int ntau, double* __restrict__ S,  // (nl, ntau, 27)
                   long long* __restrict__ nsteps,    // (nl,)
                   int* __restrict__ status) {        // (nl,)
  extern __shared__ double work[];                    // work_doubles(L)
  const int lane = order ? order[blockIdx.x] : (int)blockIdx.x;
  const pk::Team tm{(int)threadIdx.x, kWarp};
  pk::Lane ln;
  ln.k = lanes[lane];
  const double tau_ini = lanes[nlanes + lane];
  ln.t_tca = lanes[2 * nlanes + lane];
  ln.t_ufa = lanes[3 * nlanes + lane];
  ln.t_rsa = lanes[4 * nlanes + lane];
  ln.t_ncfa = lanes[5 * nlanes + lane];
  ln.ic = ic ? ic[lane] : pk::kIcAd;
  // the eta - 1 storage of the low-k lanes is the synchronous gauge's, and
  // the adiabatic mode's
  ln.eta_off = kNewt ? 0.0 : (ln.ic == pk::kIcAd && ln.k < k_eta_split ? 1.0 : 0.0);
  ln.K = K;
  ln.sgnK = sgnK;
  ln.sl = nullptr;
  long long steps = 0;
  const int st = pk::integrate_lane<kNewt, kScf, kIdm>(
      L, T, tm, ln, tau_ini, taus, ntau, rtol + (long)lane * L.n, atol + (long)lane * L.n,
      max_steps, work, S + (long)lane * ntau * pk::kNSrc, &steps,
      PK_PROFILE_OUT(lane, nlanes));
  if (tm.tid == 0) {
    nsteps[lane] = steps;
    status[lane] = st;
  }
}

// One launch of the instance (kNewt, kScf, kIdm); its shared-memory limit is
// raised past 48 KB when the lane scratch needs it.
template <bool kNewt, bool kScf, bool kIdm>
int launch(const pk::LayoutOf<kIdm>& L, const pk::TablesOf<kIdm>& T, size_t smem,
           const double* lanes,
           const double* taus, const double* rtol, const double* atol, const int* ic,
           const int* order, double k_eta_split, double K, int sgnK, long max_steps, int nlanes,
           int ntau, double* S, long long* nsteps, int* status, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        perturb_ark_kernel<kNewt, kScf, kIdm>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  perturb_ark_kernel<kNewt, kScf, kIdm><<<nlanes, kWarp, smem, stream>>>(
      L, T, lanes, taus, rtol, atol, ic, order, k_eta_split, K, sgnK, max_steps, nlanes, ntau, S,
      nsteps, status);
  return (int)cudaGetLastError();
}

}  // namespace

// layout: kLayoutInts host ints (pk::read_layout). Every other pointer is a
// device pointer. ncdm: q (nq), w (ns, nq), dlnf0 (ns, nq), x_fac (ns),
// pref (ns) packed in this order (none of them when ns = 0), then with idm_dr
// the idr damping's alpha_l and beta_l (1 + n_F_idr each; solve.py
// `kernel_ncdm`); null when there is nothing. K: the spatial curvature in
// 1/Mpc^2, sgnK its sign; gauge 0 synchronous, 1 Newtonian (any other value
// is refused, and so is a scalar field or idm_dr in the Newtonian gauge, and
// idm_dr with a scalar field). ic: each lane's initial condition (null: all
// adiabatic); order: the lane of each block (null: block b runs lane b), a
// permutation of 0..nlanes-1. The lane's scratch is dynamic shared
// memory, sized from the layout (any number of species): a state too wide for
// one block's 227 KB is refused here, and before that by the wrapper
// (solve.py `check_lane_scratch`), which names N_ncdm.
extern "C" int perturb_ark_launch(const int* layout, const double* lanes, const double* taus,
                                  const double* bg_y, const double* bg_y2, double bg_x0,
                                  double bg_dx, int bg_n, const double* th_y,
                                  const double* th_y2, double th_x0, double th_dx, int th_n,
                                  const double* ncdm, const double* rtol, const double* atol,
                                  const int* ic, const int* order,
                                  double k_eta_split, double K, int sgnK, int gauge,
                                  long long max_steps, int nlanes, int ntau, double* S,
                                  long long* nsteps, int* status, void* stream) {
  pk::LayoutIdm LI;
  pk::read_layout(layout, LI);
  const pk::Layout& L = LI;
  const bool idm = LI.idm >= 0;
  const size_t smem = (size_t)(idm ? pk::work_doubles(LI) : pk::work_doubles(L)) * sizeof(double);
  if (nlanes < 1 || smem > 232448 || gauge < 0 || gauge > 1 || (gauge == 1) != (L.theta_cdm >= 0)
      || (gauge == 1 && (L.phi_scf >= 0 || idm)) || (idm && L.phi_scf >= 0))
    return (int)cudaErrorInvalidValue;
  pk::TablesIdm TI;
  pk::Tables& T = TI;
  T.bg_y = bg_y; T.bg_y2 = bg_y2; T.bg_x0 = bg_x0; T.bg_dx = bg_dx; T.bg_n = bg_n;
  T.bg_ncol = idm ? pk::bg_cols(LI) : pk::bg_cols(L);
  T.th_y = th_y; T.th_y2 = th_y2; T.th_x0 = th_x0; T.th_dx = th_dx; T.th_n = th_n;
  const long nsq = (long)L.ns * L.nq;
  T.q = ncdm; T.w = ncdm + L.nq; T.dlnf0 = T.w + nsq; T.x_fac = T.dlnf0 + nsq;
  T.pref = T.x_fac + L.ns;
  TI.idr_alpha = T.pref + L.ns;
  TI.idr_beta = TI.idr_alpha + 1 + LI.n_F_idr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gauge == 1)
    return launch<true, false, false>(L, T, smem, lanes, taus, rtol, atol, ic, order,
                                      k_eta_split, K, sgnK, (long)max_steps, nlanes, ntau, S,
                                      nsteps, status, st);
  if (L.phi_scf >= 0)
    return launch<false, true, false>(L, T, smem, lanes, taus, rtol, atol, ic, order,
                                      k_eta_split, K, sgnK, (long)max_steps, nlanes, ntau, S,
                                      nsteps, status, st);
  if (idm)
    return launch<false, false, true>(LI, TI, smem, lanes, taus, rtol, atol, ic, order,
                                      k_eta_split, K, sgnK, (long)max_steps, nlanes, ntau, S,
                                      nsteps, status, st);
  return launch<false, false, false>(L, T, smem, lanes, taus, rtol, atol, ic, order, k_eta_split,
                                     K, sgnK, (long)max_steps, nlanes, ntau, S, nsteps, status,
                                     st);
}

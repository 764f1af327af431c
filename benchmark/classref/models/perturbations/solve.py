"""Perturbation solve: every k mode (lane) integrated through all source
sampling times.

Counterpart of classpp_public_tpu/models/perturbations/solve.py
(`make_ncdm_ctx` :37, `_stepper` :198-314, `solve_one_k` :317,
`compute_perturbations` :448-755). Each lane has its own time, step, next
sample and switch times, and takes adaptive ARK4(3)6L steps:

- the step is clipped so it never straddles a switch time (TCA off, UFA on,
  RSA on, ncdm fluid on) or the lane's next sample time;
- accept/reject per lane with the 0.9 ratio^(-1/4) controller clipped to
  [0.2, 5];
- the state remaps fire where an accepted step lands on a switch;
- at each sample reached, the source row S[k, tau, :] is evaluated from the
  state.

`integrate_sources_plain` takes lanes, samples, tables and tolerances and
returns (S, nsteps): the lanes form the leading axis of a (nlanes, nstate)
state and step in lockstep; lanes that reach a sample store their state in a
table, and the sources are evaluated from it in one batched pass after the
loop. The host reads the lane state only every `SYNC_EVERY` iterations, to
stop, drop finished lanes and skip the TCA remap once no lane can cross that
switch any more. Every lane is adiabatic, in the synchronous gauge; the
low-k lanes store eta - 1 (JAX solve.py:203-207).

The JAX package's chunk, window and mesh scheduling and its 256-bucketing
(solve.py:514-737) are TPU launch shaping and have no counterpart here: the
CMB lanes and the P(k)-tail lanes, which differ in their tolerances
(solve.py:590-655), go in one call with per-lane, per-component tolerances.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ... import constants as const
from ...config.params import CosmoParams
from ...config.precision import PrecisionParams
from ...ops.ode import ark43_step
from ..background import ncdm_psd_weights, ncdm_q_rule
from . import equations as eq
from .grids import get_k_list, get_k_schedule, get_tau_sampling
from .indices import PtIdx, SrcIdx

K_ETA_SPLIT = 0.02   # 1/Mpc: below this, adiabatic lanes store eta - 1
SYNC_EVERY = 32      # loop iterations between host reads of the lane state
SOURCE_CHUNK = 65536  # lanes per batched source evaluation
MAX_ITERATIONS = 1_000_000  # a lane still running after this many steps has stalled
# The benchmark's control (benchmark/harness/control.py) sets these to the
# JAX package's float32 working-state rule: the lane state stored in float32
# after every step and rtol floored at its tol_perturb_f32_floor
# (classpp_public_tpu/config/precision.py:186-189). The reference keeps
# float64 and no floor.
STATE_DTYPE = torch.float64
RTOL_FLOOR = 0.0



def make_ncdm_ctx(params: CosmoParams, idx: PtIdx) -> eq.NcdmCtx:
    """The shared ncdm phase-space context: Gauss-Laguerre momentum nodes
    shared across species with per-species weights w = weight e^q f0(q) and
    dln f0/dln q (tensors on the host; solve.py:37-75)."""
    qn, wf, dlnf0 = ncdm_psd_weights(params, idx.q_size_ncdm, gauss=idx.q_gauss,
                                     qmax=idx.q_max_ncdm)
    I0 = 7.0 * math.pi**4 / 120.0
    rho_g0 = const.rho_gamma_class_units(params.T_cmb)
    x_fac, pref = [], []
    for i in range(idx.n_ncdm):
        T_ratio = params.T_ncdm_of(i)
        T0_eV = const.k_B * params.T_cmb * T_ratio / const.eV_SI
        x_fac.append(params.m_ncdm[i] / T0_eV)
        pref.append(params.deg_ncdm_of(i) * (7.0 / 8.0) * T_ratio**4 * rho_g0 / I0)
    return eq.NcdmCtx(*(torch.as_tensor(np.asarray(a, dtype=np.float64))
                        for a in (qn, wf, dlnf0, x_fac, pref)))


class Lanes(NamedTuple):
    """Per-lane schedule (tensors on the solve's device)."""

    k: torch.Tensor
    tau_ini: torch.Tensor
    t_tca: torch.Tensor
    t_ufa: torch.Tensor
    t_rsa: torch.Tensor
    t_ncfa: torch.Tensor   # +inf without ncdm: the switch never fires

    def take(self, sel) -> "Lanes":
        return Lanes(*(v[sel] for v in self))


class PerturbResult(NamedTuple):
    k: torch.Tensor            # (nk,)
    tau: torch.Tensor          # (ntau,)
    sources: torch.Tensor      # (nk, ntau, SrcIdx.n), the adiabatic mode
    tau0: float
    k_size_cmb: int
    stats_steps: torch.Tensor  # (nk,) step attempts per mode (adiabatic)
    k_np: np.ndarray = None
    tau_np: np.ndarray = None


def _ctx(lanes: Lanes, t, eta_off, tables, kf=None):
    return eq.PertCtx(k=lanes.k, tca_on=t < lanes.t_tca, rsa_on=t >= lanes.t_rsa,
                      ufa_on=t >= lanes.t_ufa, eta_off=eta_off, tables=tables,
                      ncdmfa_on=t >= lanes.t_ncfa, kf=kf)


def curvature_of(params: CosmoParams, bg) -> tuple:
    """(K, sgnK): K = -Omega_k H0^2 [Mpc^-2] (reference pba->K) and its sign."""
    K = float(-params.Omega_k * float(bg.H0) ** 2)
    return K, 0 if params.Omega_k == 0.0 else (1 if K > 0 else -1)


def _eta_off(k):
    """The eta storage offset per lane: 1 on the low-k lanes (JAX
    solve.py:203-207, eta_flag)."""
    return (k < K_ETA_SPLIT).to(k.dtype)


class _LaneState:
    """The integration state of the live lanes, as tensors updated in place
    by `_step` (so that a CUDA graph of one step can be replayed)."""

    FIELDS = ("ids", "k", "tau_ini", "t_tca", "t_ufa", "t_rsa", "t_ncfa", "eta_off", "rtol", "atol",
              "t", "y", "h", "j", "done", "nsteps")

    def __init__(self, **kw):
        for f in self.FIELDS:
            setattr(self, f, kw[f])

    def take(self, sel) -> "_LaneState":
        return _LaneState(**{f: getattr(self, f)[sel] for f in self.FIELDS})

    def lanes(self) -> Lanes:
        return Lanes(self.k, self.tau_ini, self.t_tca, self.t_ufa, self.t_rsa, self.t_ncfa)


def _step(s: _LaneState, tables, taus_ext, Yflat, ntau: int, need_tca: bool, kf=None):
    """One adaptive step of every lane, in place (solve.py:268-312); kf: the
    lanes' eq.k_factors."""
    ln = s.lanes()
    t, y, h, j, done = s.t, s.y, s.h, s.j, s.done
    sw = torch.stack([ln.t_tca, ln.t_ufa, ln.t_rsa, ln.t_ncfa], dim=1)
    t_b = taus_ext[j]
    cand = torch.where(sw > (t * (1.0 + 1e-14))[:, None], sw, torch.inf)
    t_stop = torch.minimum(cand.min(dim=1).values, t_b)
    h_eff = torch.minimum(h, t_stop - t)
    ctx = _ctx(ln, t, s.eta_off, tables, kf=kf)
    y_new, err, k1 = ark43_step(
        lambda fr, yy: eq.rhs(fr, yy, ctx), lambda fr, yy: eq.stiff_apply(fr, yy, ctx),
        lambda fr, gh, r: eq.stiff_solve(fr, gh, r, ctx), t, y, h_eff, ctx,
        prepare=lambda ti, c: eq.frame_at(ti, c.tables))
    scale = s.rtol * (y.abs() + (h_eff[:, None] * k1).abs() + 1e-30) + s.atol
    ratio = (err.abs() / scale).max(dim=1).values
    ratio = torch.where(torch.isfinite(ratio), ratio, torch.inf)
    live = ~done
    accept = (ratio <= 1.0) & live
    fac = torch.clamp(0.9 * torch.where(ratio > 0, ratio ** -0.25, 5.0), 0.2, 5.0)
    h_next = torch.where(accept & (h_eff < h), torch.maximum(h, h_eff * fac), h_eff * fac)
    t_new = torch.where(accept, t + h_eff, t)
    y_out = torch.where(accept[:, None], y_new, y)
    # state remaps where an accepted step lands on a switch time
    crossed = accept[:, None] & (t_new[:, None] >= sw) & (t[:, None] < sw)
    if need_tca:
        remapped = eq.remap_tca_off(y_out, eq.frame_at(t_new, tables),
                                    _ctx(ln, t_new, s.eta_off, tables, kf=kf))
        y_out = torch.where(crossed[:, 0:1], remapped, y_out)
    y_out = eq.remap_ufa_on(y_out, tables.idx, crossed[:, 1])
    y_out = eq.remap_rsa_on(y_out, tables.idx, crossed[:, 2])
    if tables.idx.n_ncdm:
        y_out = eq.remap_ncdmfa_on(y_out, eq.frame_at(t_new, tables),
                                   _ctx(ln, t_new, s.eta_off, tables, kf=kf), crossed[:, 3])
    # a lane that reaches its next sample stores its state there; the others
    # write to their spare slot
    arrived = live & (t_new >= t_b * (1.0 - 1e-15))
    Yflat.index_copy_(0, s.ids * (ntau + 1) + torch.where(arrived, j, ntau), y_out)
    s.h.copy_(torch.where(live, torch.clamp(h_next, min=1e-300), h))
    s.nsteps.add_(live)
    s.t.copy_(torch.where(arrived, t_b, t_new))
    s.y.copy_(y_out)
    s.j.add_(arrived)
    s.done.copy_(s.j >= ntau)


def _runner(fn, on_card: bool):
    """fn itself, or on a card the replay of a CUDA graph of fn: one step is
    ~4000 small kernels whose eager launch costs far more than their work.
    The warm-up call before the capture is a real step; returns (run,
    steps_taken)."""
    if not on_card:
        return fn, 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay, 1


def integrate_sources_plain(lanes: Lanes, taus: torch.Tensor, tables: eq.PertTables,
                            tolerances) -> tuple:
    """All lanes in lockstep from tau_ini through all samples `taus` (on a
    card, one CUDA graph per step). tolerances: (rtol, atol), each (nlanes,
    nstate). Returns (S (nlanes, ntau, SrcIdx.n), nsteps (nlanes,)), nsteps
    counting step attempts as the JAX integrator does."""
    rtol_all, atol_all = tolerances
    rtol_all = torch.clamp(rtol_all, min=RTOL_FLOOR)
    dev, f64 = taus.device, taus.dtype
    nl_tot, ntau = lanes.k.shape[0], taus.shape[0]
    n = tables.idx.size
    # one spare sample slot per lane absorbs the writes of lanes that did
    # not reach a sample this iteration
    Y = torch.zeros((nl_tot, ntau + 1, n), dtype=f64, device=dev)
    Yflat = Y.view(nl_tot * (ntau + 1), n)
    taus_ext = torch.cat([taus, taus[-1:]])
    nsteps_all = torch.zeros(nl_tot, dtype=torch.long, device=dev)

    eta_off = _eta_off(lanes.k)
    t0 = lanes.tau_ini.clone()
    y0 = eq.initial_conditions(eq.frame_at(t0, tables), _ctx(lanes, t0, eta_off, tables))
    s = _LaneState(ids=torch.arange(nl_tot, device=dev), k=lanes.k, tau_ini=lanes.tau_ini,
                   t_tca=lanes.t_tca, t_ufa=lanes.t_ufa, t_rsa=lanes.t_rsa,
                   t_ncfa=lanes.t_ncfa, eta_off=eta_off,
                   rtol=rtol_all, atol=atol_all, t=t0, y=y0.to(STATE_DTYPE),
                   h=0.1 * lanes.tau_ini,
                   j=torch.zeros(nl_tot, dtype=torch.long, device=dev),
                   done=torch.zeros(nl_tot, dtype=torch.bool, device=dev),
                   nsteps=torch.zeros(nl_tot, dtype=torch.long, device=dev))
    on_card = dev.type == "cuda"
    need_tca = True
    run, it = None, 0
    while True:
        if run is None:
            # the k-only factors of the live lanes, once for the step's graph
            kf = eq.k_factors(s.k, tables.K, tables.idx)
            run, taken = _runner(lambda: _step(s, tables, taus_ext, Yflat, ntau, need_tca, kf),
                                 on_card)
            it += taken
        run()
        it += 1
        if it % SYNC_EVERY:
            continue
        if it > MAX_ITERATIONS:
            raise RuntimeError(f"perturbation integration stalled: {it} steps, "
                               f"{int((~s.done).sum())} lanes unfinished")
        # --- host checkpoint: stop, drop finished lanes, retire the TCA remap
        done = s.done
        n_keep = int((~done).sum())
        if n_keep == 0:
            nsteps_all[s.ids] = s.nsteps
            break
        if n_keep <= 0.75 * s.ids.shape[0]:
            nsteps_all[s.ids[done]] = s.nsteps[done]
            s = s.take(torch.nonzero(~done).squeeze(1))
            run = None
        tca_left = bool((s.t < s.t_tca).any())
        if tca_left != need_tca:
            need_tca, run = tca_left, None

    S = torch.empty((nl_tot, ntau, SrcIdx.n), dtype=f64, device=dev)
    flat_tau = taus.repeat(nl_tot)
    flat_lane = torch.arange(nl_tot, device=dev).repeat_interleave(ntau)
    Ys = Y[:, :ntau].reshape(nl_tot * ntau, n)
    Sflat = S.view(nl_tot * ntau, SrcIdx.n)
    for c0 in range(0, nl_tot * ntau, SOURCE_CHUNK):
        c1 = min(c0 + SOURCE_CHUNK, nl_tot * ntau)
        lane = flat_lane[c0:c1]
        tt = flat_tau[c0:c1]
        ctx = _ctx(lanes.take(lane), tt, eta_off[lane], tables)
        Sflat[c0:c1] = eq.compute_sources(eq.frame_at(tt, tables), Ys[c0:c1], ctx)
    return S, nsteps_all


def _tolerances(k: np.ndarray, idx: PtIdx, pr: PrecisionParams, tail: bool,
                k_pp_max: float):
    """Per-lane, per-component (rtol, atol) (solve.py:594-655): CMB lanes
    tight; P(k)-tail lanes loosened on the radiation rows (rtol x
    tol_perturb_tail_factor, atol floor) except beyond k_pp_max, where the
    lensing potential cannot reach and every row is loose."""
    rtol = pr.tol_perturb_integration
    n = idx.size
    if not tail:
        return np.full((len(k), n), rtol), np.full((len(k), n), 1e-11)
    tail_factor = pr.tol_perturb_tail_factor
    tail_atol = pr.atol_perturb_tail_radiation
    atol_rad = np.full(n, 3e-8)
    rtol_tail = np.full(n, rtol)
    for s0, s1 in idx.radiation_slices:
        atol_rad[s0:s1] = tail_atol
        rtol_tail[s0:s1] = rtol * tail_factor
    rt = np.where((k <= k_pp_max)[:, None], rtol_tail[None, :], rtol * tail_factor)
    return rt, np.broadcast_to(atol_rad, (len(k), n)).copy()


def compute_perturbations(params: CosmoParams, pr: PrecisionParams, bg, bidx, th,
                          l_scalar_max: int = 2500, k_max_for_pk: float = 10.0,
                          has_cls: bool = True, has_pk: bool = True,
                          z_max_pk: float = 5.0, has_lcmb: bool = False,
                          k_max_cl_extra: float = 0.0, has_nc: bool = False,
                          device=None) -> PerturbResult:
    """Full scalar perturbation stage: grids + schedule + batched solve.
    has_nc (number counts) samples k and tau as C_l's do (solve.py:454-472:
    the reference's has_cls includes nCl/sCl, perturbations_module.cpp:1700)."""
    if pr.evolver != "imex":
        raise NotImplementedError(
            "only the imex evolver is ported (classpp_public_tpu/ops/ode.py:44 rkck)")
    device = torch.device(device) if device is not None else bg.loga.device
    ks = get_k_list(params, pr, bg, th, l_scalar_max=l_scalar_max,
                    k_max_for_pk=k_max_for_pk, has_cls=has_cls or has_nc, has_pk=has_pk,
                    k_max_cl_extra=k_max_cl_extra)
    taus = get_tau_sampling(params, pr, bg, bidx, th, has_cmb=has_cls or has_nc,
                            z_max_pk=z_max_pk)
    k_max_cmb = pr.k_max_tau0_over_l_max * l_scalar_max / float(bg.tau0) if has_cls else 0.0
    k_max_cmb = max(k_max_cmb, k_max_cl_extra)
    sched = get_k_schedule(ks, pr, bg, bidx, th, tau_first_sample=float(taus[0]),
                           n_ncdm=params.N_ncdm, tol_ncdm_initial_w=pr.tol_ncdm_initial_w,
                           k_max_cmb=k_max_cmb)
    k_size_cmb = int(np.searchsorted(ks, k_max_cmb, side="right")) if has_cls else 0
    k_size_cmb = min(k_size_cmb + 1, len(ks))
    nq_ncdm, q_gauss, q_max_ncdm = ncdm_q_rule(params, pr)
    # curvature: K = -Omega_k H0^2 (solve.py:480-481)
    K, sgnK = curvature_of(params, bg)
    idx = PtIdx(l_max_g=pr.l_max_g, l_max_pol_g=pr.l_max_pol_g, l_max_ur=pr.l_max_ur,
                n_ncdm=params.N_ncdm, l_max_ncdm=pr.l_max_ncdm, q_size_ncdm=nq_ncdm,
                q_gauss=q_gauss, q_max_ncdm=q_max_ncdm, sgnK=sgnK)
    ncdm = make_ncdm_ctx(params, idx).to(device) if idx.n_ncdm else None
    tables = eq.make_tables(bg, bidx, th, idx, ncdm, K)
    tables = tables._replace(bg=tables.bg.to(device), th=tables.th.to(device))
    t_ncfa = sched.tau_ncdmfa_on if idx.n_ncdm else np.full_like(ks, np.inf)
    taus_t = torch.as_tensor(taus, dtype=torch.float64, device=device)
    k_pp_max = (l_scalar_max + 0.5) / 900.0 if has_lcmb else 0.0
    n_cmb = int(np.searchsorted(ks, k_max_cmb, side="right")) if k_max_cmb > 0 else 0

    def dt(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=device)

    # the CMB lanes and the P(k)-tail lanes go in one call, ordered by k: the
    # tolerances are per lane and no lane waits for another
    n_cmb = min(n_cmb, len(ks))
    tols = [_tolerances(ks[i0:i1], idx, pr, tail, k_pp_max)
            for i0, i1, tail in ((0, n_cmb, False), (n_cmb, len(ks), True))]
    lanes = Lanes(*(dt(a) for a in (sched.k, sched.tau_ini, sched.tau_tca_off,
                                    sched.tau_ufa_on, sched.tau_rsa_on, t_ncfa)))
    tol = tuple(dt(np.concatenate([t[i] for t in tols])) for i in (0, 1))
    sources, steps = integrate_sources_plain(lanes, taus_t, tables, tol)
    if pr.curvature_ini != 1.0:
        sources = sources * pr.curvature_ini
    return PerturbResult(k=dt(ks), tau=taus_t, sources=sources, tau0=float(bg.tau0),
                         k_size_cmb=k_size_cmb, stats_steps=steps,
                         k_np=np.asarray(ks), tau_np=np.asarray(taus))

"""Tensor-mode perturbations (gravitational waves) in open, flat and closed
universes.

Counterpart of classpp_public_tpu/models/perturbations/tensors.py (`TnIdx`
:33-100, `rhs_full` :136-278, `tensor_ic` :285, `remap_tca_off` :303,
`remap_rsa_on` :314, `solve_one_k` :321-381, `get_tensor_solver` :384-400,
`compute_tensor_perturbations` :411-455, the ncdm context :422-446). Reference physics:
perturb_derivs tensor block (perturbations_module.cpp:9045-9228), the
Einstein equation gw'' = -2 aH gw' - (k^2 + 2K) gw + gw_source
(perturb_einstein :6036), the sources S_T2 = -gw' e^-kappa + g P and
S_P = sqrt(6) g P (perturb_sources :7243-7273). Curvature K enters through
s_l = sqrt(max(1 - K (l^2 - 1)/k^2, 0)), cotKgen (tensors.py:156-171), the
k^2 + 2K of the gw equation and the curved amplitude of the initial gw
(`tensor_ic`); when flat, s_l = 1 and cotKgen = 1/(k tau) exactly.

The state is gw, gw', the photon temperature F_l and polarization G_l
hierarchies, (methods `massless` and `exact`) one massless-neutrino hierarchy
driven by rho_ur + 3 p_ncdm (`massless`) or rho_ur alone (`exact`), and
(method `exact`) the free-streaming Psi_l(q) hierarchy of every massive
species, whose anisotropic stress sources gw'' (perturb_derivs :9158-9205,
perturb_total_stress_energy :6700-6745). Every lane (k
mode) takes adaptive Cash-Karp steps clipped to its switch times (tight
coupling off, radiation streaming on), with the JAX solver's step control,
and emits (S_T2, S_P) at every tau sample.

`tensor_rkck` integrates all lanes: on CUDA tensors one launch of the
hand-written kernel csrc/tensor_rkck.cu (one lane per warp; the per-lane
program is csrc/tensor_rkck.cuh), on CPU tensors `tensor_rkck_plain`, the
lanes batched along the leading axis of an (nlanes, n) state.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from ...config.params import CosmoParams, check_lcdm
from ...config.precision import PrecisionParams
from ...ops import cuda
from ...ops.ode import rkck_step
from ..background import ncdm_q_rule
from ..thermodynamics import ThIdx
from .equations import NcdmCtx, curvature
from .solve import MAX_LANE_SCRATCH_BYTES, _runner, curvature_of, make_ncdm_ctx

_SQRT6 = math.sqrt(6.0)
MAX_INTERVAL_STEPS = 100_000   # per sample interval (solve_one_k :338)
SYNC_EVERY = 32                # plain loop iterations between host reads

# table columns read by the equations (the kernel's Frame order)
BG_COLS = ("a", "H", "rho_g", "rho_ur")
TH_COLS = ("dkappa", "g", "exp_m_kappa")

launches = 0  # tensor_rkck kernel launches (tensor_rkck on CUDA tensors)


@dataclass(frozen=True)
class TnIdx:
    """Tensor state layout: gw, gw', photon temperature F_l (l = 0..l_max_g_ten),
    photon polarization G_l, the ur hierarchy (none for method `photons`)
    and, for method `exact`, the Psi_l(q) block of the n_ncdm massive species
    (species, then momentum, then l). Under `massless` the n_ncdm species'
    3 p_ncdm joins rho_ur as the ur hierarchy's driving density."""

    l_max_g_ten: int = 5
    l_max_pol_g_ten: int = 5
    l_max_ur: int = 17
    n_ncdm: int = 0
    method: str = "massless"     # photons | massless | exact
    sgnK: int = 0                # sign of the curvature: 0 flat, -1 open, +1 closed
    q_size_ncdm: int = 0
    l_max_ncdm: int = 17

    gw = 0
    gwdot = 1
    F = 2

    @property
    def n_F(self):
        return self.l_max_g_ten + 1

    @property
    def G(self):
        return self.F + self.n_F

    @property
    def n_G(self):
        return self.l_max_pol_g_ten + 1

    @property
    def ur(self):
        return self.G + self.n_G

    @property
    def n_ur(self):
        return 0 if self.method == "photons" else self.l_max_ur + 1

    @property
    def n_rho_ncdm(self):
        """ncdm species whose 3 p_ncdm drive the massless hierarchy."""
        return self.n_ncdm if self.method == "massless" else 0

    @property
    def n_exact(self):
        """ncdm species with a Psi_l(q) hierarchy of their own."""
        return self.n_ncdm if self.method == "exact" else 0

    @property
    def n_l_ncdm(self):
        return self.l_max_ncdm + 1

    @property
    def ncdm(self):
        return self.ur + self.n_ur

    @property
    def n_ncdm_block(self):
        return self.n_exact * self.q_size_ncdm * self.n_l_ncdm

    @property
    def size(self):
        return self.ncdm + self.n_ncdm_block


class TensorTables(NamedTuple):
    """The background and thermodynamics runtime splines restricted to the
    columns the tensor equations read: BG_COLS then p_ncdm of each species
    in idx.n_rho_ncdm; TH_COLS. ncdm: the momentum data of the idx.n_exact
    species (method `exact`), else None."""

    bg: object    # UniformSpline over ln(tau)
    th: object
    idx: TnIdx
    K: float = 0.0   # spatial curvature [Mpc^-2]; its sign is idx.sgnK
    ncdm: NcdmCtx = None


def make_tables(bg, bidx, th, idx: TnIdx, K: float = 0.0, ncdm: NcdmCtx = None) -> TensorTables:
    if (ncdm is None) != (idx.n_exact == 0):
        raise ValueError("tensor tables: the ncdm momentum data go with method exact and "
                         "N_ncdm > 0, and only there")
    bi = [bidx[n] for n in BG_COLS] + [bidx[f"p_ncdm{i}"] for i in range(idx.n_rho_ncdm)]
    ti = [ThIdx.ix[n] for n in TH_COLS]
    b, t = bg.lntau_spline, th.lntau_spline
    return TensorTables(
        bg=b._replace(y=b.y[:, bi].contiguous(), y2=b.y2[:, bi].contiguous()),
        th=t._replace(y=t.y[:, ti].contiguous(), y2=t.y2[:, ti].contiguous()), idx=idx, K=K,
        ncdm=ncdm)


class Frame(NamedTuple):
    """Table values at one time per lane."""

    tau: torch.Tensor
    a: torch.Tensor
    H: torch.Tensor
    rho_g: torch.Tensor
    rho_ur: torch.Tensor
    kap: torch.Tensor
    g: torch.Tensor
    emk: torch.Tensor
    p_nc: torch.Tensor = None   # (L, ns)


def frame_at(tau: torch.Tensor, tables: TensorTables) -> Frame:
    lntau = torch.log(tau)
    bgv = tables.bg.eval(lntau)
    thv = tables.th.eval(lntau).unbind(-1)
    nb = len(BG_COLS)
    return Frame(tau, *bgv[:, :nb].unbind(-1), *thv, p_nc=bgv[:, nb:])


class TensorCtx(NamedTuple):
    """Per-lane data fixed during one step: wavenumber, the approximation
    flags at the step's start time, the curvature K and the ncdm momentum
    data (method `exact`)."""

    k: torch.Tensor
    tca_on: torch.Tensor   # bool
    rsa_on: torch.Tensor
    idx: TnIdx
    K: float = 0.0
    ncdm: NcdmCtx = None


def _hier_deriv(Fv, k, ck, s_of_l, kap=None):
    """Free-streaming hierarchy derivative of F_l, l = 0..L (`_hier_deriv`
    :116-133): k/(2l+1) (l s_l F_{l-1} - (l+1) s_{l+1} F_{l+1}), the
    truncation k (s_L F_{L-1} - (L+1) cotKgen F_L) at l = L, minus kap F_l.
    The caller overrides the low moments. Fv (L, nl); k, ck, kap (L,);
    s_of_l(l) -> (L, len(l))."""
    nl = Fv.shape[1]
    ls = torch.arange(nl, dtype=Fv.dtype, device=Fv.device)
    sl, sl1 = s_of_l(ls), s_of_l(ls + 1.0)
    zero = torch.zeros_like(Fv[:, :1])
    Fm1 = torch.cat([zero, Fv[:, :-1]], dim=1)
    Fp1 = torch.cat([Fv[:, 1:], zero], dim=1)
    d = k[:, None] / (2.0 * ls + 1.0) * (ls * sl * Fm1 - (ls + 1.0) * sl1 * Fp1)
    d[:, -1] = k * (sl[:, -1] * Fv[:, -2] - nl * ck * Fv[:, -1])
    if kap is not None:
        d = d - kap[:, None] * Fv
    return d


def rhs_full(fr: Frame, y: torch.Tensor, ctx: TensorCtx):
    """dy/dtau (L, n) and the sources (S_T2, S_P) of every lane (rhs_full
    :136-278)."""
    idx = ctx.idx
    k = ctx.k
    k2 = k * k
    tau = fr.tau
    a = fr.a
    aH = a * fr.H
    a2 = a * a
    kap = fr.kap
    tca, rsa = ctx.tca_on, ctx.rsa_on
    hier_on = (~tca) & (~rsa)
    # curvature coefficients (the shared s_l array, perturb_workspace :2532);
    # the tensor equations use s2 = s_l[2]^2
    K = ctx.K
    cv = curvature(k, tau, K, idx.sgnK)
    s_of_l, s_l2, s_l3, ck = cv.s_of_l, cv.s_l2, cv.s_l3, cv.cotKgen
    s_l4 = s_of_l(torch.full((1,), 4.0, dtype=k.dtype, device=k.device))[:, 0]
    s2 = s_l2 * s_l2

    gw = y[:, idx.gw]
    gwdot = y[:, idx.gwdot]
    F = y[:, idx.F: idx.F + idx.n_F]
    G = y[:, idx.G: idx.G + idx.n_G]
    delta_g, theta_g, shear_g = F[:, 0], F[:, 1], F[:, 2]

    gw_src_g = torch.where(
        hier_on,
        -_SQRT6 * 4.0 * a2 * fr.rho_g * (delta_g / 15.0 + 4.0 / 21.0 * shear_g + F[:, 4] / 35.0),
        0.0)
    gw_src_ur = 0.0
    if idx.n_ur:
        U = y[:, idx.ur: idx.ur + idx.n_ur]
        delta_ur, theta_ur, shear_ur = U[:, 0], U[:, 1], U[:, 2]
        rho_rel = fr.rho_ur
        for i in range(idx.n_rho_ncdm):
            rho_rel = rho_rel + 3.0 * fr.p_nc[:, i]
        gw_src_ur = -_SQRT6 * 4.0 * a2 * rho_rel * (delta_ur / 15.0 + 4.0 / 21.0 * shear_ur
                                                    + U[:, 4] / 35.0)
    gw_src_nc = 0.0
    if idx.n_ncdm_block:
        # the exact ncdm stress (perturb_total_stress_energy :6700-6745): per
        # species pref/a^4 sum_q w q^4/eps (Psi0/15 + 2/21 Psi2 + Psi4/35)
        nc = ctx.ncdm
        Psi, eps = _ncdm_block(y, a, idx, nc)
        qw = nc.w * nc.q[None, :] ** 2
        moments = Psi[..., 0] / 15.0 + 2.0 / 21.0 * Psi[..., 2] + Psi[..., 4] / 35.0
        integ = torch.sum(qw * nc.q[None, :] ** 2 / eps * moments, dim=2)
        gw_src_nc = -_SQRT6 * 4.0 * a2 * torch.sum(nc.pref / (a2 * a2)[:, None] * integ, dim=1)
    # the curvature shift k^2 -> k^2 + 2K (perturb_einstein :6039)
    gw_pp = -2.0 * aH * gwdot - (k2 + 2.0 * K) * gw + gw_src_g + gw_src_ur + gw_src_nc

    P2 = -(1.0 / _SQRT6) * (delta_g / 10.0 + 2.0 / 7.0 * shear_g + 3.0 / 70.0 * F[:, 4]
                            - 3.0 / 5.0 * G[:, 0] + 6.0 / 7.0 * G[:, 2] - 3.0 / 70.0 * G[:, 4])

    dy = torch.zeros_like(y)
    dy[:, idx.gw] = gwdot
    dy[:, idx.gwdot] = gw_pp
    dF = _hier_deriv(F, k, ck, s_of_l, kap)
    dF[:, 0] = -4.0 / 3.0 * theta_g - kap * (delta_g + _SQRT6 * P2) + _SQRT6 * gwdot
    dF[:, 1] = k2 * (delta_g / 4.0 - s_l2 * shear_g) - kap * theta_g
    dF[:, 2] = 4.0 / 15.0 * s_l2 * theta_g - 3.0 / 10.0 * k * s_l3 * F[:, 3] - kap * shear_g
    dF[:, 3] = k / 7.0 * (6.0 * s_l3 * shear_g - 4.0 * s_l4 * F[:, 4]) - kap * F[:, 3]
    dy[:, idx.F: idx.F + idx.n_F] = torch.where(hier_on[:, None], dF, 0.0)
    dG = _hier_deriv(G, k, ck, s_of_l, kap)
    dG[:, 0] = -k * G[:, 1] - kap * (G[:, 0] - _SQRT6 * P2)
    dy[:, idx.G: idx.G + idx.n_G] = torch.where(hier_on[:, None], dG, 0.0)
    if idx.n_ur:
        dU = _hier_deriv(U, k, ck, s_of_l)
        dU[:, 0] = -4.0 / 3.0 * theta_ur + _SQRT6 * gwdot
        dU[:, 1] = k2 * (delta_ur / 4.0 - s2 * shear_ur)
        dU[:, 2] = 4.0 / 15.0 * theta_ur - 3.0 / 10.0 * k * s_l3 / s_l2 * U[:, 3]
        dU[:, 3] = k / 7.0 * (6.0 * s_l3 * s_l2 * shear_ur - 4.0 * s_l4 * U[:, 4])
        dy[:, idx.ur: idx.ur + idx.n_ur] = dU
    if idx.n_ncdm_block:
        # the free-streaming Psi_l(q) hierarchy (perturb_derivs :9158-9205):
        # dPsi0 = -(qk/eps) Psi1 - sqrt(6)/4 gw' dlnf0/dlnq; 0 < l < L the s_l
        # couplings; the truncation dPsi_L = (qk/eps) Psi_{L-1} - (L+1) k cotKgen Psi_L
        nl = idx.n_l_ncdm
        qke = k[:, None, None] * nc.q / eps                               # (L, ns, nq)
        ls = torch.arange(nl, dtype=y.dtype, device=y.device)
        sl, sl1 = s_of_l(ls)[:, None, None, :], s_of_l(ls + 1.0)[:, None, None, :]
        zero = torch.zeros_like(Psi[..., :1])
        Pm1 = torch.cat([zero, Psi[..., :-1]], dim=3)
        Pp1 = torch.cat([Psi[..., 1:], zero], dim=3)
        dP = qke[..., None] / (2.0 * ls + 1.0) * (ls * sl * Pm1 - (ls + 1.0) * sl1 * Pp1)
        dP[..., 0] = -qke * Psi[..., 1] - 0.25 * _SQRT6 * gwdot[:, None, None] * nc.dlnf0
        dP[..., -1] = qke * Psi[..., -2] - (nl * k * ck)[:, None, None] * Psi[..., -1]
        dy[:, idx.ncdm:] = dP.reshape(dP.shape[0], -1)

    P_src = torch.where(rsa, 0.0, torch.where(tca, 2.0 / 5.0 * _SQRT6 * gwdot / kap, P2))
    s_t2 = -gwdot * fr.emk + fr.g * P_src
    s_p = _SQRT6 * fr.g * P_src
    return dy, (s_t2, s_p)


def _ncdm_block(y, a, idx: TnIdx, nc: NcdmCtx):
    """The Psi_l(q) block of every lane (L, ns, nq, nl) and eps(q, a) =
    sqrt(q^2 + (a m/T0)^2) (L, ns, nq)."""
    ns, nq, nl = idx.n_exact, idx.q_size_ncdm, idx.n_l_ncdm
    Psi = y[:, idx.ncdm:].reshape(y.shape[0], ns, nq, nl)
    eps = torch.sqrt(nc.q ** 2 + (a[:, None] * nc.x_fac[None, :])[:, :, None] ** 2)
    return Psi, eps


def tensor_amplitude(k: torch.Tensor, K: float, sgnK: int) -> torch.Tensor:
    """gw at the initial time per lane (tensor_ic :285-299): 1/sqrt(6), in
    curved space times the eigentensor factor sqrt(k^2 (k^2 - K)/((k^2 + 3K)
    (k^2 + 2K))) and, in open models, the bubble-nucleation factor
    sqrt(tanh(pi/2 sqrt(q^2/-K))) with q^2 = k^2 + 3K (zero where q^2 < 0), so
    that the primordial P_h(k) keeps its flat form."""
    amp = torch.full_like(k, 1.0 / _SQRT6)
    if sgnK == 0:
        return amp
    k2 = k * k
    amp = amp * torch.sqrt(k2 * (k2 - K) / ((k2 + 3.0 * K) * (k2 + 2.0 * K)))
    if sgnK < 0:
        q2 = torch.clamp(k2 + 3.0 * K, min=0.0)
        amp = amp * torch.sqrt(torch.tanh(math.pi / 2.0 * torch.sqrt(q2) / math.sqrt(-K)))
        amp = torch.where(k2 + 3.0 * K >= 0.0, amp, 0.0)
    return amp


def tensor_ic(idx: TnIdx, nlanes: int, dtype=torch.float64, device="cpu", k=None,
              K: float = 0.0) -> torch.Tensor:
    """Adiabatic tensor initial state: gw from `tensor_amplitude` (flat when k
    is None), everything else 0; a gw_ini other than 1 scales the sources
    after the solve."""
    y = torch.zeros((nlanes, idx.size), dtype=dtype, device=device)
    if k is None:
        y[:, idx.gw] = 1.0 / _SQRT6
    else:
        y[:, idx.gw] = tensor_amplitude(k, K, idx.sgnK)
    return y


def remap_tca_off(y: torch.Tensor, fr: Frame, idx: TnIdx, on: torch.Tensor) -> torch.Tensor:
    """perturb_vector_init :4657: seed delta_g and G0 from gw' where `on`."""
    gwdot = y[:, idx.gwdot]
    out = y.clone()
    out[:, idx.F] = torch.where(on, -4.0 / 3.0 * gwdot / fr.kap, y[:, idx.F])
    out[:, idx.G] = torch.where(on, 1.0 / 3.0 * gwdot / fr.kap, y[:, idx.G])
    return out


def remap_rsa_on(y: torch.Tensor, idx: TnIdx, on: torch.Tensor) -> torch.Tensor:
    """Zero the photon hierarchies where `on` (:314)."""
    out = y.clone()
    sl = slice(idx.F, idx.G + idx.n_G)
    out[:, sl] = torch.where(on[:, None], 0.0, y[:, sl])
    return out


class TensorLanes(NamedTuple):
    """Per-lane schedule (tensors on the solve's device)."""

    k: torch.Tensor
    tau_ini: torch.Tensor
    t_tca: torch.Tensor
    t_rsa: torch.Tensor

    def take(self, sel) -> "TensorLanes":
        return TensorLanes(*(v[sel] for v in self))


def _ctx(lanes: TensorLanes, t, tables: TensorTables):
    return TensorCtx(k=lanes.k, tca_on=t < lanes.t_tca, rsa_on=t >= lanes.t_rsa,
                     idx=tables.idx, K=tables.K, ncdm=tables.ncdm)


def _stalled(nsteps, lanes):
    return RuntimeError(f"tensor integration stalled: an interval of a lane took "
                        f"{MAX_INTERVAL_STEPS} steps (k = {float(lanes.k[0]):.6g}/Mpc, "
                        f"{int(nsteps[0])} steps in all)")


class _PlainState(NamedTuple):
    """The lockstep integration state of every lane, updated in place by
    `_plain_step` (so that a CUDA graph of one step can be replayed)."""

    ids: torch.Tensor
    sw: torch.Tensor       # (nl, 2): t_tca, t_rsa
    t: torch.Tensor
    y: torch.Tensor
    h: torch.Tensor
    j: torch.Tensor        # next sample of each lane
    n_int: torch.Tensor    # steps in the current sample interval
    nsteps: torch.Tensor
    capped: torch.Tensor   # an interval took MAX_INTERVAL_STEPS steps


def _plain_step(st: _PlainState, lanes: TensorLanes, taus_ext, Yflat, tables: TensorTables,
                rtol: float, ntau: int) -> None:
    """One Cash-Karp step of every lane, in place (solve_one_k :340-359): a
    lane that finishes an interval stores its state for that sample."""
    idx = tables.idx
    t, y, h, j, n_int = st.t, st.y, st.h, st.j, st.n_int
    live = j < ntau
    t_b = taus_ext[j]
    cand = torch.where(st.sw > (t * (1.0 + 1e-14))[:, None], st.sw, torch.inf)
    t_stop = torch.minimum(cand.min(dim=1).values, t_b)
    h_eff = torch.minimum(h, t_stop - t)
    ctx = _ctx(lanes, t, tables)
    y_new, err, k1 = rkck_step(lambda ti, yy: rhs_full(frame_at(ti, tables), yy, ctx)[0],
                               t, y, h_eff)
    scale = rtol * (y.abs() + (h_eff[:, None] * k1).abs() + 1e-30) + 1e-11
    ratio = (err.abs() / scale).max(dim=1).values
    ratio = torch.where(torch.isfinite(ratio), ratio, torch.inf)
    accept = (ratio <= 1.0) & live
    fac = torch.clamp(0.9 * torch.where(ratio > 0, ratio ** -0.2, 5.0), 0.2, 5.0)
    h_next = torch.where(accept & (h_eff < h), torch.maximum(h, h_eff * fac), h_eff * fac)
    t_new = torch.where(accept, t + h_eff, t)
    y_out = torch.where(accept[:, None], y_new, y)
    crossed = accept[:, None] & (t_new[:, None] >= st.sw) & (t[:, None] < st.sw)
    y_out = remap_tca_off(y_out, frame_at(t_new, tables), idx, crossed[:, 0])
    y_out = remap_rsa_on(y_out, idx, crossed[:, 1])
    n_int_new = n_int + live
    arrived = live & ((t_new >= t_b * (1.0 - 1e-15)) | (n_int_new >= MAX_INTERVAL_STEPS))
    st.capped.logical_or_(arrived & (n_int_new >= MAX_INTERVAL_STEPS))
    Yflat.index_copy_(0, st.ids * (ntau + 1) + torch.where(arrived, j, ntau), y_out)
    st.h.copy_(torch.where(live, torch.clamp(h_next, min=1e-300), h))
    st.nsteps.add_(live)
    st.t.copy_(torch.where(arrived, t_b, t_new))
    st.y.copy_(y_out)
    st.j.add_(arrived)
    st.n_int.copy_(torch.where(arrived, 0, n_int_new))


def tensor_rkck_plain(lanes: TensorLanes, taus: torch.Tensor, tables: TensorTables,
                      rtol: float) -> tuple:
    """Plain PyTorch version of `tensor_rkck`: all lanes step in lockstep,
    each with its own time, step, sample interval and step count
    (solve_one_k :321-381; on a card one CUDA graph per step, as the scalar
    plain integrator). A lane that finishes an interval stores its state for
    that sample; the sources are evaluated from the stored states after the
    loop. Returns (S (nl, ntau, 2), nsteps (nl,))."""
    idx = tables.idx
    dev, f64 = taus.device, taus.dtype
    nl, ntau, n = lanes.k.shape[0], taus.shape[0], idx.size
    Y = torch.zeros((nl, ntau + 1, n), dtype=f64, device=dev)   # + a spare slot
    Yflat = Y.view(nl * (ntau + 1), n)
    ids = torch.arange(nl, device=dev)
    y = tensor_ic(idx, nl, dtype=f64, device=dev, k=lanes.k, K=tables.K)
    # a first sample at or before tau_ini takes no step (its interval is empty)
    empty = taus[0] <= lanes.tau_ini
    Y[:, 0] = torch.where(empty[:, None], y, Y[:, 0])
    st = _PlainState(ids=ids, sw=torch.stack([lanes.t_tca, lanes.t_rsa], dim=1),
                     t=torch.where(empty, taus[0], lanes.tau_ini), y=y, h=0.1 * lanes.tau_ini,
                     j=empty.long(), n_int=torch.zeros(nl, dtype=torch.long, device=dev),
                     nsteps=torch.zeros(nl, dtype=torch.long, device=dev),
                     capped=torch.zeros(nl, dtype=torch.bool, device=dev))
    taus_ext = torch.cat([taus, taus[-1:]])
    run, it = None, 0
    while True:
        if it % SYNC_EVERY == 0 and not bool((st.j < ntau).any()):
            break
        if run is None:
            run, it = _runner(lambda: _plain_step(st, lanes, taus_ext, Yflat, tables, rtol, ntau),
                              dev.type == "cuda")
        run()
        it += 1
    if bool(st.capped.any()):
        raise _stalled(st.nsteps[st.capped], lanes.take(st.capped))
    tau_rows = taus.repeat(nl)
    lane_rows = lanes.take(ids.repeat_interleave(ntau))
    _, (s_t2, s_p) = rhs_full(frame_at(tau_rows, tables), Y[:, :ntau].reshape(nl * ntau, n),
                              _ctx(lane_rows, tau_rows, tables))
    S = torch.stack([s_t2, s_p], dim=1).reshape(nl, ntau, 2)
    return S, st.nsteps


def _layout_ints(idx: TnIdx) -> list:
    """TnIdx as the int fields of the kernel's tk::Layout, in its order."""
    return [idx.size, idx.F, idx.n_F, idx.G, idx.n_G, idx.ur, idx.n_ur, idx.n_rho_ncdm,
            idx.ncdm, idx.n_exact, idx.q_size_ncdm, idx.n_l_ncdm]


def sl_count(idx: TnIdx) -> int:
    """Entries of the lane's s_l table, l = 0..: every l a hierarchy couples
    (tk::sl_count)."""
    return max(idx.n_F, idx.n_G, idx.n_ur, idx.n_l_ncdm if idx.n_exact else 0) + 1


def work_doubles(idx: TnIdx) -> int:
    """Scratch doubles per lane of the kernel (tk::work_doubles): y, the
    stage state, y5, six stage derivatives (9 n), the frame buffer and the
    s_l table."""
    return 9 * idx.size + 16 + sl_count(idx)


def check_lane_scratch(idx: TnIdx) -> int:
    """The kernel's lane scratch in bytes; raises when one block cannot hold
    it (too many exact ncdm species or momenta for the card's shared memory)."""
    nbytes = 8 * work_doubles(idx)
    if nbytes > MAX_LANE_SCRATCH_BYTES:
        raise ValueError(
            f"tensor_rkck: N_ncdm = {idx.n_exact} under tensor method exact "
            f"({idx.q_size_ncdm} momenta, state {idx.size}) needs {nbytes} bytes of lane "
            f"scratch, above the {MAX_LANE_SCRATCH_BYTES} bytes (227 KB) of shared memory a "
            f"block can hold")
    return nbytes


def ncdm_pack(tables: TensorTables):
    """The exact species' momentum data in the kernel's order (q, w, dlnf0,
    x_fac, pref) as one contiguous float64 vector, or None."""
    if tables.ncdm is None:
        return None
    return torch.cat([v.reshape(-1) for v in tables.ncdm]).contiguous()


KERNEL_STATUS = {1: "took MAX_INTERVAL_STEPS steps in one interval"}


def tensor_rkck(lanes: TensorLanes, taus: torch.Tensor, tables: TensorTables,
                rtol: float) -> tuple:
    """Integrate every tensor lane from tau_ini through all samples `taus`.
    Returns (S (nlanes, ntau, 2): S_T2, S_P; nsteps (nlanes,), counting step
    attempts as the JAX integrator does). CUDA tensors: one launch of the
    tensor_rkck kernel (one lane per warp); CPU tensors: the plain version."""
    global launches
    dev = taus.device
    if dev.type == "cpu":
        return tensor_rkck_plain(lanes, taus, tables, rtol)
    if dev.type != "cuda":
        raise ValueError(f"tensor_rkck: unsupported device {dev}")
    idx = tables.idx
    nl, ntau = lanes.k.shape[0], taus.shape[0]
    bg, th = tables.bg, tables.th
    if bg.y.shape[1] != len(BG_COLS) + idx.n_rho_ncdm or th.y.shape[1] != len(TH_COLS):
        raise ValueError(f"tensor_rkck: bad table shapes bg{tuple(bg.y.shape)} "
                         f"th{tuple(th.y.shape)}")
    if len(BG_COLS) + idx.n_rho_ncdm + len(TH_COLS) > 16:
        raise ValueError("tensor_rkck: too many table columns for the frame buffer")
    check_lane_scratch(idx)
    lane_tab = torch.stack(list(lanes), dim=0).contiguous()   # (4, nl)
    ncdm = ncdm_pack(tables)
    for t in (lane_tab, taus, bg.y, bg.y2, th.y, th.y2) + ((ncdm,) if ncdm is not None else ()):
        if t.dtype != torch.float64 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"tensor_rkck: every input must be contiguous float64 on {dev}")
    lib = cuda.library()
    S = torch.empty((nl, ntau, 2), dtype=torch.float64, device=dev)
    nsteps = torch.zeros(nl, dtype=torch.long, device=dev)
    status = torch.zeros(nl, dtype=torch.int32, device=dev)
    ints = _layout_ints(idx)
    layout = (ctypes.c_int * len(ints))(*ints)
    err = lib.tensor_rkck_launch(
        layout, lane_tab.data_ptr(), taus.data_ptr(), bg.y.data_ptr(), bg.y2.data_ptr(),
        float(bg.x0), float(bg.dx), int(bg.n), th.y.data_ptr(), th.y2.data_ptr(),
        float(th.x0), float(th.dx), int(th.n), ncdm.data_ptr() if ncdm is not None else None,
        float(rtol), float(tables.K), int(idx.sgnK), MAX_INTERVAL_STEPS, nl, ntau,
        S.data_ptr(), nsteps.data_ptr(), status.data_ptr(), cuda.stream_ptr(dev))
    cuda.check(err, "tensor_rkck")
    launches += 1
    st = status.cpu()   # the one host read: waits for the launch
    if bool(st.any()):
        i = int(torch.nonzero(st)[0])
        raise RuntimeError(f"tensor integration failed: lane k = {float(lanes.k[i]):.6g}/Mpc "
                           f"{KERNEL_STATUS.get(int(st[i]), st[i])} after {int(nsteps[i])} steps "
                           f"({int((st != 0).sum())} of {nl} lanes failed)")
    return S, nsteps


class TensorResult(NamedTuple):
    k: torch.Tensor          # (nk,)
    tau: torch.Tensor        # (ntau,)
    sources: torch.Tensor    # (nk, ntau, 2): S_T2, S_P
    tau0: float
    stats_steps: torch.Tensor = None   # (nk,) step attempts per mode
    k_np: np.ndarray = None


def check_tensor_method(params: CosmoParams) -> None:
    """Raise for a tensor neutrino treatment the code does not have: an
    unknown method, and (as the JAX package, tensors.py:424-427) method
    `exact` with decaying ncdm."""
    if params.tensor_method not in ("photons", "massless", "exact"):
        raise ValueError(f"unknown tensor method {params.tensor_method!r}")
    if params.tensor_method == "exact" and params.N_ncdm and params.N_ncdm_decay_dr:
        from ...classy import CosmoSevereError

        raise CosmoSevereError("tensor method = exact with decaying ncdm not implemented")


def tensor_ncdm_ctx(params: CosmoParams, pr: PrecisionParams, device) -> tuple:
    """(q_size_ncdm, NcdmCtx on `device`) of the exact ncdm hierarchy
    (compute_tensor_perturbations :429-439): the scalar solve's momentum
    rule and phase-space data; (0, None) unless method `exact` with ncdm."""
    if params.tensor_method != "exact" or not params.N_ncdm:
        return 0, None
    nq, q_gauss, q_max = ncdm_q_rule(params, pr)
    rule = SimpleNamespace(q_size_ncdm=nq, q_gauss=q_gauss, q_max_ncdm=q_max,
                           n_ncdm=params.N_ncdm)
    return nq, make_ncdm_ctx(params, rule).to(device)


def compute_tensor_perturbations(params: CosmoParams, pr: PrecisionParams, bg, bidx, th,
                                 l_tensor_max: int = 500, device=None) -> TensorResult:
    """The tensor source table on the tensor k grid (compute_tensor_perturbations
    :411-455)."""
    from .grids import get_k_list, get_k_schedule, get_tau_sampling

    check_tensor_method(params)
    check_lcdm(params)
    device = torch.device(device) if device is not None else bg.loga.device
    ks = get_k_list(params, pr, bg, th, l_scalar_max=l_tensor_max, k_max_for_pk=0.0,
                    has_cls=True, has_pk=False, m_mode=2)
    taus = get_tau_sampling(params, pr, bg, bidx, th, has_cmb=True)
    sched = get_k_schedule(ks, pr, bg, bidx, th, tau_first_sample=float(taus[0]))
    K, sgnK = curvature_of(params, bg)
    nq, ncdm = tensor_ncdm_ctx(params, pr, device)
    idx = TnIdx(pr.l_max_g_ten, pr.l_max_pol_g_ten, pr.l_max_ur, params.N_ncdm,
                params.tensor_method, sgnK, q_size_ncdm=nq, l_max_ncdm=pr.l_max_ncdm)
    tables = make_tables(bg, bidx, th, idx, K, ncdm)
    tables = tables._replace(bg=tables.bg.to(device), th=tables.th.to(device))

    def dt(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=device)

    lanes = TensorLanes(dt(sched.k), dt(sched.tau_ini), dt(sched.tau_tca_off),
                        dt(sched.tau_rsa_on))
    taus_t = dt(taus)
    S, steps = tensor_rkck(lanes, taus_t, tables, pr.tol_perturb_integration)
    if pr.gw_ini != 1.0:
        # the system is linear: scaling the sources is scaling the IC (precisions.h:221)
        S = S * pr.gw_ini
    return TensorResult(k=dt(ks), tau=taus_t, sources=S, tau0=float(bg.tau0),
                        stats_steps=steps, k_np=np.asarray(ks))

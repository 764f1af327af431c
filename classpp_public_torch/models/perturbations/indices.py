"""Static state-vector layout for scalar perturbations (counterpart of
classpp_public_tpu/models/perturbations/indices.py).

One fixed maximal layout: slots inactive under the current approximation
carry zero derivative and are re-initialised by a remap at the switch. The
port holds the LambdaCDM + ur layout in the synchronous or the Newtonian
gauge (open, flat or closed) plus the ncdm phase-space block and, in the
synchronous gauge, the scalar field's (delta phi, delta phi') or the
interacting dark matter and dark radiation block (idm_dr); the other
species' flags of the JAX PtIdx raise.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PtIdx:
    """Index layout, parametrised by the hierarchy truncations l_max_g,
    l_max_pol_g, l_max_ur, l_max_ncdm (include/precisions.h:209-215) and the
    ncdm phase-space discretisation (species x momentum x multipole)."""

    l_max_g: int = 12
    l_max_pol_g: int = 10
    l_max_ur: int = 17
    n_ncdm: int = 0
    q_size_ncdm: int = 16
    # momentum-node rule behind q_size_ncdm (background.ncdm_q_rule)
    q_gauss: bool = True
    q_max_ncdm: float = 32.0
    l_max_ncdm: int = 17
    has_fld: bool = False
    has_dcdm: bool = False
    has_scf: bool = False
    # interacting dark matter <-> dark radiation (ETHOS; indices.py:55-75):
    # the idr hierarchy to l_max_idr, none beyond the shear in fluid mode,
    # and the per-l angular coefficients of its l >= 2 damping (entries for
    # l = 2..l_max_idr, shorter lists padded with their last entry; (): the
    # reference's all-1.5)
    has_idm_dr: bool = False
    l_max_idr: int = 17
    idr_fluid: bool = False
    alpha_idm_dr: tuple = ()
    beta_idr: tuple = ()
    # "synchronous" | "newtonian": in the Newtonian gauge the state gains
    # theta_cdm and the eta slot holds the Bardeen potential phi
    # (indices.py:36-39)
    gauge: str = "synchronous"
    # sign of the spatial curvature (reference pba->sgnK): 0 flat, -1 open,
    # +1 closed (indices.py:40-42)
    sgnK: int = 0
    nbody: bool = False

    # the JAX line of each species flag that is not ported
    _NOT_PORTED = {"has_fld": 35, "has_dcdm": 45, "nbody": 89}

    def __post_init__(self):
        for name, line in self._NOT_PORTED.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"perturbation layout {name} is not ported "
                    f"(classpp_public_tpu/models/perturbations/indices.py:{line})")
        if self.gauge not in ("synchronous", "newtonian"):
            raise ValueError(f"unknown gauge {self.gauge!r}")
        if self.has_scf and self.gauge == "newtonian":
            raise NotImplementedError(
                "scalar-field dark energy in the Newtonian gauge is not ported "
                "(classpp_public_tpu/models/perturbations/equations.py:401-407, :1374-1385)")
        if self.has_idm_dr and self.gauge == "newtonian":
            raise NotImplementedError(
                "interacting dark matter and dark radiation in the Newtonian gauge are not "
                "ported (classpp_public_tpu/models/perturbations/equations.py:1369-1373)")
        if self.has_idm_dr and self.has_scf:
            raise NotImplementedError(
                "interacting dark matter and dark radiation together with a scalar field are "
                "not ported (classpp_public_tpu/models/perturbations/equations.py:301-318, "
                ":818-851)")

    def idr_damping_coeffs(self):
        """(alpha_l, beta_l) tuples of length l_max_idr - 1 (l = 2..l_max_idr;
        indices.py:69-75)."""
        n = self.l_max_idr - 1

        def pad(t):
            t = tuple(float(x) for x in t) or (1.5,)
            return (t + (t[-1],) * (n - len(t)))[:n]

        return pad(self.alpha_idm_dr), pad(self.beta_idr)

    delta_g = 0
    theta_g = 1
    shear_g = 2
    F_g = 3  # F_g[l] for l = 3..l_max_g lives at F_g + (l - 3)

    @property
    def n_F_g(self):
        return self.l_max_g - 2

    @property
    def G_g(self):  # polarization G_l, l = 0..l_max_pol_g
        return self.F_g + self.n_F_g

    @property
    def n_G_g(self):
        return self.l_max_pol_g + 1

    @property
    def delta_b(self):
        return self.G_g + self.n_G_g

    @property
    def theta_b(self):
        return self.delta_b + 1

    @property
    def delta_cdm(self):
        return self.theta_b + 1

    @property
    def theta_cdm(self):
        # Newtonian gauge only (the synchronous gauge fixes theta_cdm = 0)
        return self.delta_cdm + 1

    @property
    def n_theta_cdm(self):
        return 1 if self.gauge == "newtonian" else 0

    @property
    def delta_ur(self):
        return self.delta_cdm + 1 + self.n_theta_cdm

    @property
    def theta_ur(self):
        return self.delta_ur + 1

    @property
    def shear_ur(self):
        return self.theta_ur + 1

    @property
    def F_ur(self):  # l = 3..l_max_ur
        return self.shear_ur + 1

    @property
    def n_F_ur(self):
        return self.l_max_ur - 2

    # interacting dark matter and dark radiation, after the ur block
    # (indices.py:186-219): delta, theta of the idm, then delta, theta, shear
    # of the idr (the shear slot kept, and zero, in fluid mode) and its
    # moments l = 3..l_max_idr
    @property
    def delta_idm_dr(self):
        return self.F_ur + self.n_F_ur

    @property
    def theta_idm_dr_pt(self):
        return self.delta_idm_dr + 1

    @property
    def delta_idr(self):
        return self.delta_idm_dr + 2

    @property
    def theta_idr(self):
        return self.delta_idm_dr + 3

    @property
    def shear_idr(self):
        return self.delta_idm_dr + 4

    @property
    def F_idr(self):  # l = 3..l_max_idr
        return self.delta_idm_dr + 5

    @property
    def n_F_idr(self):
        return self.l_max_idr - 2 if self.has_idm_dr and not self.idr_fluid else 0

    @property
    def n_idm_dr(self):
        return 5 + self.n_F_idr if self.has_idm_dr else 0

    # ncdm: per species a (q_size x (l_max_ncdm + 1)) block; under the fluid
    # approximation only its first three slots (delta, theta, sigma) evolve
    @property
    def ncdm(self):
        return self.F_ur + self.n_F_ur + self.n_idm_dr

    @property
    def n_l_ncdm(self):
        return self.l_max_ncdm + 1

    @property
    def n_ncdm_block(self):
        return self.n_ncdm * self.q_size_ncdm * self.n_l_ncdm

    # scalar-field dark energy: delta phi and its conformal derivative
    # (indices.py:258-269), after the ncdm block
    @property
    def phi_scf_pt(self):
        return self.ncdm + self.n_ncdm_block

    @property
    def phi_prime_scf_pt(self):
        return self.phi_scf_pt + 1

    @property
    def n_scf(self):
        return 2 if self.has_scf else 0

    @property
    def eta(self):
        return self.ncdm + self.n_ncdm_block + self.n_scf

    @property
    def size(self):
        return self.eta + 1

    @property
    def radiation_slices(self):
        """(start, stop) ranges of the relativistic hierarchies (photons +
        polarization, ur, idr): the rows loosened on the P(k) tail
        (indices.py:278-296)."""
        out = ((self.delta_g, self.G_g + self.n_G_g),
               (self.delta_ur, self.F_ur + self.n_F_ur))
        if self.has_idm_dr:
            out += ((self.delta_idr, self.F_idr + self.n_F_idr),)
        return out


class SrcIdx:
    """Source-type columns (index_tp_*, perturbations_module.h)."""

    names = ["t0", "t1", "t2", "p", "phi", "psi", "phi_plus_psi", "phi_prime",
             "delta_m", "theta_m", "delta_cb", "theta_cb", "h_prime", "eta_src",
             "delta_g", "theta_g", "delta_b", "theta_b", "delta_cdm",
             "theta_cdm", "delta_ur", "theta_ur", "delta_ncdm", "theta_ncdm",
             "delta_tot", "H_T_Nb_prime", "theta_tot"]
    ix = {n: i for i, n in enumerate(names)}
    n = len(names)

"""Static state-vector layout for scalar perturbations (counterpart of
classpp_public_tpu/models/perturbations/indices.py).

One fixed maximal layout: slots inactive under the current approximation
carry zero derivative and are re-initialised by a remap at the switch. The
reference holds what the benchmark's cells run: the LambdaCDM + ur layout in
the synchronous gauge plus the ncdm phase-space block.
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
    # sign of the spatial curvature (reference pba->sgnK): 0 flat, -1 open,
    # +1 closed (indices.py:40-42)
    sgnK: int = 0

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
    def delta_ur(self):
        return self.delta_cdm + 1

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

    # ncdm: per species a (q_size x (l_max_ncdm + 1)) block; under the fluid
    # approximation only its first three slots (delta, theta, sigma) evolve
    @property
    def ncdm(self):
        return self.F_ur + self.n_F_ur

    @property
    def n_l_ncdm(self):
        return self.l_max_ncdm + 1

    @property
    def n_ncdm_block(self):
        return self.n_ncdm * self.q_size_ncdm * self.n_l_ncdm

    @property
    def eta(self):
        return self.ncdm + self.n_ncdm_block

    @property
    def size(self):
        return self.eta + 1

    @property
    def radiation_slices(self):
        """(start, stop) ranges of the relativistic hierarchies (photons +
        polarization, ur): the rows loosened on the P(k) tail
        (indices.py:278-296)."""
        return ((self.delta_g, self.G_g + self.n_G_g),
                (self.delta_ur, self.F_ur + self.n_F_ur))


class SrcIdx:
    """Source-type columns (index_tp_*, perturbations_module.h)."""

    names = ["t0", "t1", "t2", "p", "phi", "psi", "phi_plus_psi", "phi_prime",
             "delta_m", "theta_m", "delta_cb", "theta_cb", "h_prime", "eta_src",
             "delta_g", "theta_g", "delta_b", "theta_b", "delta_cdm",
             "theta_cdm", "delta_ur", "theta_ur", "delta_ncdm", "theta_ncdm",
             "delta_tot", "H_T_Nb_prime", "theta_tot"]
    ix = {n: i for i, n in enumerate(names)}
    n = len(names)

"""classpp_public_torch: the PyTorch/CUDA port of classpp_public_tpu.

The same Einstein-Boltzmann pipeline (background -> thermodynamics ->
perturbations -> primordial -> nonlinear -> transfer -> spectra -> lensing)
in float64 PyTorch, with its serial and data-parallel hot loops (RECFAST and
the Tb march, the scalar and tensor perturbation integrators, halofit's
sums, the scalar and tensor line-of-sight scans, flat and hyperspherical,
the lensing Wigner recurrences) as hand-written CUDA kernels for Hopper
(csrc/). The port covers LambdaCDM, open, flat or closed, with massless and
Fermi-Dirac massive neutrinos, halofit, tensor modes, RECFAST and HyRec,
the synchronous and the Newtonian gauge, and adiabatic initial conditions.

Importing the package builds nothing and starts nothing; the kernels are
compiled at their first launch on a card.
"""

from .classy import Class, CosmoSevereError
from .config.params import CosmoParams
from .config.precision import PrecisionParams
from .pipeline import Cosmology, OutputSelection

__version__ = "0.1.0"

__all__ = ["Class", "CosmoSevereError", "CosmoParams", "PrecisionParams", "Cosmology",
           "OutputSelection", "__version__"]

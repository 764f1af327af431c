"""classref: the benchmark's plain reference, a frozen copy of the Python
pipeline of classpp_public_torch (classy entry, config, ops, the background,
thermodynamics, perturbation, nonlinear, transfer, spectra, lensing and
number-count stages and their data tables) as it stood when the benchmark was
defined.

What differs from the program it was copied from:
- no CUDA kernel: every function that dispatched to a hand-written kernel
  keeps only its plain PyTorch branch, on any device (the plain integrator
  and the plain lensing replay one CUDA graph a step or a multipole on a
  card), and the kernel library loader `ops/cuda.py` and the launch counters
  are gone;
- the perturbation integrator's working-state type and rtol floor
  (`models/perturbations/solve.py` STATE_DTYPE, RTOL_FLOOR), float64 and 0
  here, which only the benchmark's control changes.

It imports nothing of classpp_public_torch, jax or classpp_public_tpu, and is
never edited to follow the program: a later change of the program is judged
against this copy.
"""

from .classy import Class, CosmoSevereError
from .config.params import CosmoParams
from .config.precision import PrecisionParams
from .pipeline import Cosmology, OutputSelection

__version__ = "0.1.0"

__all__ = ["Class", "CosmoSevereError", "CosmoParams", "PrecisionParams", "Cosmology",
           "OutputSelection", "__version__"]

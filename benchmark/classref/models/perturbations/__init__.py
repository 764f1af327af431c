from .solve import PerturbResult, compute_perturbations  # noqa: F401

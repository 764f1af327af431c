"""output_stages_s (s/point): the spans of the stages the cell runs after the
perturbations (primordial, nonlinear, transfer, spectra, lensing, number
counts) and of the cell's reads, summed per point, mean over the traced
window's points."""

BEFORE = ("set", "background", "thermodynamics", "perturbations")


def read(run):
    per_point = [sum(v for k, v in s.items() if k not in BEFORE) for s in run.stage_s]
    return sum(per_point) / len(per_point) if per_point else None

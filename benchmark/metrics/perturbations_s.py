"""perturbations_s (s/point): the benchmark's span around the program's
`perturbations` stage, closed by a synchronize, mean over the traced window's
points."""


def read(run):
    spans = [s["perturbations"] for s in run.stage_s if "perturbations" in s]
    return sum(spans) / len(spans) if spans else None

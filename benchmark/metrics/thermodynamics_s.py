"""thermodynamics_s (s/point): the benchmark's span around the program's
`thermodynamics` stage, closed by a synchronize, mean over the traced window's
points."""


def read(run):
    spans = [s["thermodynamics"] for s in run.stage_s if "thermodynamics" in s]
    return sum(spans) / len(spans) if spans else None

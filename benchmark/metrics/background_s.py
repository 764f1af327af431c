"""background_s (s/point): the benchmark's span around the program's
`background` stage, closed by a synchronize, mean over the traced window's
points."""


def read(run):
    spans = [s["background"] for s in run.stage_s if "background" in s]
    return sum(spans) / len(spans) if spans else None

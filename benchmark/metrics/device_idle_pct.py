"""device_idle_pct (%): the share of the traced window in which no
operation ran on the card, 100 (1 - busy / window), busy the union of the
device activities in the profiler's trace."""


def read(run):
    if not run.trace or run.trace["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])

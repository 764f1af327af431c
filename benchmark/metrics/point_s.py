"""point_s (s/point): the window's seconds over the points it completed,
every point a full set, compute and the cell's reads, one in flight."""


def read(run):
    return run.window_s / run.points if run.points else None

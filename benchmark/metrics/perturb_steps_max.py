"""perturb_steps_max (steps): the program's step counter of the perturbation
stage (`stats_steps`, step attempts per lane), its largest lane per point,
mean over the traced window's points: the lane that sets perturb_ark's
pace."""


def read(run):
    return sum(run.steps_max) / len(run.steps_max) if run.steps_max else None

"""The `metropolis` generator: a sampler's chain of parameter points.

A Metropolis random walk over the configuration's walked parameters
(`walk`: {classy key: sigma}; a key `name[i]` walks the i-th entry of a
comma-separated list such as `selection_bias`). The proposal is
N(0, (proposal_factor / sqrt(d)) sigma_i) about the current point, the
acceptance is against a Gaussian stand-in posterior N(centre,
posterior_width sigma_i), and every proposal is a point to compute, as a
chain computes every proposal before it accepts or rejects it. The walk
depends on the seed alone: the program's outputs never steer it, so the same
seed gives the same points on both sides of a comparison.

The mix's data file gives `proposal_factor` and `posterior_width`.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np

from harness.traffic import point, value_of


def points(config: dict, mix: dict, seed: int) -> Iterator[dict]:
    """The points of the walk from the configuration's centre, endless."""
    keys = list(config["walk"])
    sigma = np.array([float(config["walk"][k]) for k in keys])
    centre = np.array([value_of(config["params"], k) for k in keys])
    step = mix["proposal_factor"] / math.sqrt(len(keys)) * sigma
    width = mix["posterior_width"] * sigma
    rng = np.random.default_rng(int(seed) % 2**64)

    def log_post(x):
        return -0.5 * float(np.sum(((x - centre) / width) ** 2))

    x, lp = centre, 0.0
    while True:
        prop = x + step * rng.standard_normal(len(keys))
        yield point(config["params"], keys, prop)
        lp_prop = log_post(prop)
        if math.log(1.0 - rng.random()) < lp_prop - lp:
            x, lp = prop, lp_prop

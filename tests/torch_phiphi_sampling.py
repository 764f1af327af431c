"""How g1_lcdm's raw phiphi at l = 2 depends on the source sampling in tau.

The sampling steps in tau by a rate holding the third derivative of the
optical depth, so tables that differ in their last bits sample differently
late in tau, and the l = 2 lensing-potential transfer at k > 0.07/Mpc, where
the window (tau - tau_rec)/(tau0 - tau) meets a Bessel function that
oscillates across a sampling step, changes sign from one sampling to
another. This script measures what that does to raw phiphi at l = 2 on both
packages against tests/golden/g1_lcdm.npz (limit 1e-2):

    python3 tests/torch_phiphi_sampling.py jax STAGES.pkl    # the CPU
    python3 tests/torch_phiphi_sampling.py port STAGES.pkl   # one card
    python3 tests/torch_phiphi_sampling.py draws g1_lcdm,g9_newt   # one card

`jax` runs the JAX package's Class on the CPU with omega_cdm moved by 0,
+-1e-12 and +3e-12 (relative) and writes the unmoved run's background,
thermodynamics and tau sampling to STAGES.pkl; `port` runs the port's
Class(device="cuda") seeded with those stages, then on its own stages, and
imports nothing of JAX. `draws` runs the port's Class(device="cuda") on its
own stages for each named configuration of the g1 cosmology (g1_lcdm, and
g9_newt, the same cosmology in the Newtonian gauge) with omega_cdm moved by
the same amounts, each against its own golden. Each prints the raw phiphi
error at l = 2.
"""

import os
import pickle
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from classpp_public_torch.tools import configs  # noqa: E402
from classpp_public_torch.tools.golden_check import Golden  # noqa: E402

MOVES = (0.0, 1e-12, -1e-12, 3e-12)


def report(tag, raw, ntau, t0, golden="g1_lcdm"):
    g = Golden(golden)
    print(f"[phiphi] {tag}: {ntau} tau samples; raw phiphi at l = 2 "
          f"{g.rel('cl', 'phiphi', raw['pp'], 2, 2)[0]:.4e}, worst over l = 2..2500 "
          f"{g.rel('cl', 'phiphi', raw['pp'], 2, 2500)}; raw TT "
          f"{g.rel('cl', 'TT', raw['tt'], 2, 2500)} ({time.time() - t0:.1f} s)", flush=True)


def run_jax(path):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from classpp_public_tpu import Class
    from test_torch_common import asdict

    for move in MOVES:
        t0 = time.time()
        c = Class()
        c.set(dict(configs.G1_LCDM, omega_cdm=configs.G1_LCDM["omega_cdm"] * (1 + move)))
        c.compute(["lensing"])
        tau = c.cosmo.perturbations.tau_np
        report(f"jax, omega_cdm moved by {move:g}", c.raw_cl(2500), len(tau), t0)
        if move == 0.0:
            bg, bidx = c.cosmo.background
            with open(path, "wb") as f:
                pickle.dump(dict(bg=asdict(bg), names=list(bidx.names),
                                 th=asdict(c.cosmo.thermodynamics), tau=tau), f)


def run_port(path):
    import torch

    import classpp_public_torch as cpt
    from classpp_public_torch import interop

    with open(path, "rb") as f:
        d = pickle.load(f)
    for seeded in (True, False):
        t0 = time.time()
        c = cpt.Class(device=torch.device("cuda"))
        c.set(dict(configs.G1_LCDM))
        if seeded:
            c.cosmo.set_stage("background", interop.background(d["bg"], "cuda",
                                                               names=d["names"]))
            c.cosmo.set_stage("thermodynamics", interop.thermo(d["th"], "cuda"))
        c.compute(["lensing"])
        raw = c.raw_cl(2500)
        tau = c.cosmo.perturbations.tau_np
        if len(tau) == len(d["tau"]):
            same = f", tau {float(np.max(np.abs(tau / d['tau'] - 1))):.1e} from the JAX sampling"
        else:
            same = f", the JAX sampling has {len(d['tau'])}"
        report(("port seeded with the JAX stages" if seeded else "port, its own stages") + same,
               raw, len(tau), t0)


def run_draws(names):
    import torch

    import classpp_public_torch as cpt

    for name in names.split(","):
        keys = {**configs.CONFIGS, **configs.GOLDEN_ONLY}[name]
        for move in MOVES:
            t0 = time.time()
            c = cpt.Class(device=torch.device("cuda"))
            c.set(dict(keys, omega_cdm=keys["omega_cdm"] * (1 + move)))
            c.compute(["lensing"])
            report(f"port {name} (gauge {c.cosmo.params.gauge}), omega_cdm moved by {move:g}",
                   c.raw_cl(2500), len(c.cosmo.perturbations.tau_np), t0, golden=name)


if __name__ == "__main__":
    {"jax": run_jax, "port": run_port, "draws": run_draws}[sys.argv[1]](sys.argv[2])

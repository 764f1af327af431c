"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, and the result line.

Set-up imports the program, loads its kernel library (on a card) and
computes one warm-up point at the configuration's centre through the cell's
reads. The window then computes the chain's points back to back, one in
flight: `set(params)`, `compute()`, the reads, a synchronize; it closes at
the end of the first point that ends after `seconds`. A traced run computes
each point stage by stage instead, each stage a span closed by a
synchronize, under `torch.profiler`.

After the window, with the peak memory read and the program's state freed,
one point drawn from the seed among the window's points is computed again
by the reference, and the two sides' reads are compared.
"""

from __future__ import annotations

import contextlib
import gc
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from . import compare, manifest, reference, roofline, trace, traffic

STAGE_LEVEL = "lensing"   # Cosmology.stages(level): every stage a cell's reads need
HOST_THREADS = 1          # torch's intra-op threads: the host shares its cores


@dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    setup_s: float
    window_s: float = 0.0
    points: int = 0
    failed: int = 0
    stage_s: list = field(default_factory=list)    # traced: {stage: s} per point
    steps_max: list = field(default_factory=list)  # traced: max stats_steps per point
    work: dict = field(default_factory=dict)       # traced: kernel -> [(bound_s, bound_by)]
    trace: dict = None                             # traced: trace.reduce of the window


class Sample:
    """One item drawn uniformly from a stream of unknown length (reservoir
    sampling), the draws from the seed alone."""

    def __init__(self, seed: int):
        self._rng = np.random.default_rng([int(seed) % 2**64, 1])
        self._n = 0
        self.item = None

    def offer(self, item) -> None:
        self._n += 1
        if self._rng.integers(self._n) == 0:
            self.item = item


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """The traced run's instruments: a span per stage (host clock, closed by
    a synchronize, and a profiler annotation `bench:<stage>`), the program's
    step counter, and the work of each perturb_ark and recfast_history call,
    read from their arguments around the program's wrappers."""

    def __init__(self, run: Run, device):
        self.run, self.device = run, device
        self._undo = []

    def __enter__(self):
        from classpp_public_torch.models import thermodynamics
        from classpp_public_torch.models.perturbations import solve

        self._wrap(solve, "integrate_sources", self._perturb_ark_work)
        self._wrap(thermodynamics, "recfast_history", self._recfast_work)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._undo:
            setattr(module, name, fn)
        return False

    def _wrap(self, module, name, after):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            after(args, kwargs, out)
            return out

        setattr(module, name, wrapped)
        self._undo.append((module, name, fn))

    def _add(self, kernel: str, nbytes: float, flops: float) -> None:
        self.run.work.setdefault(kernel, []).append(roofline.bound(nbytes, flops))

    def _perturb_ark_work(self, args, kwargs, out):
        _, taus, tables, (rtol, atol) = args[:4]
        S, nsteps = out
        idx = tables.idx
        n_stiff = idx.delta_idm_dr + idx.n_idm_dr if idx.has_idm_dr else idx.theta_b + 1
        flops = roofline.perturb_ark_flops(float(nsteps.sum()), idx.size, idx.n_ncdm,
                                           idx.n_ncdm_block if idx.n_ncdm else 0, n_stiff)
        ins = (S, taus, rtol, atol, tables.bg.y, tables.bg.y2, tables.th.y, tables.th.y2)
        nbytes = roofline.perturb_ark_bytes(sum(t.numel() * t.element_size() for t in ins),
                                            nsteps.shape[0])
        self._add("perturb_ark_kernel", nbytes, flops)

    def _recfast_work(self, args, kwargs, out):
        from classpp_public_torch.models.thermodynamics import RF_PARAMS

        rp, H, nz = args[:3]
        inj = args[3] if len(args) > 3 else kwargs.get("inj_conv")
        pv = dict(zip(RF_PARAMS, rp.tolist()))
        hist = out.cpu()
        n_int = roofline.recfast_integrated_intervals(
            hist[0].flip(0).tolist(), hist[1].flip(0).tolist(), int(nz), pv["zHe3"],
            pv["dzHe3"], pv["trigHe"], pv["fHe"])
        ts = [rp, H.y, H.y2, out] + ([inj.y, inj.y2] if inj is not None else [])
        nbytes = sum(t.numel() * t.element_size() for t in ts)
        self._add("recfast_history_kernel", nbytes,
                  roofline.recfast_history_flops(int(nz), n_int, pv["inj_on"] != 0.0))

    @contextlib.contextmanager
    def span(self, name: str, spans: dict):
        import torch

        with torch.profiler.record_function(trace.SPAN_PREFIX + name):
            t = time.perf_counter()
            yield
            _sync(self.device)
        spans[name] = spans.get(name, 0.0) + time.perf_counter() - t

    def point(self, cls, params: dict, reads: list) -> dict:
        spans = {}
        with self.span("set", spans):
            cls.set(params)
            cosmo = cls.cosmo
        for stage in cosmo.stages(STAGE_LEVEL):
            with self.span(stage, spans):
                getattr(cosmo, stage)
        with self.span("reads", spans):
            out = compare.perform(cls, reads)
        self.run.stage_s.append(spans)
        self.run.steps_max.append(int(cosmo.perturbations.stats_steps.max()))
        return out


def point(cls, params: dict, reads: list, device) -> dict:
    """One point as a chain computes it: set, compute, the reads."""
    cls.set(params)
    cls.compute()
    out = compare.perform(cls, reads)
    _sync(device)
    return out


def card(device) -> dict:
    """The card's name and power limit (nvidia-smi), or what could be read."""
    import torch

    if device.type != "cuda":
        return {"kind": "cpu", "power_limit": "not read"}
    info = {"kind": torch.cuda.get_device_name(device)}
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        info["power_limit"] = res.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "not read"
    return info


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t_start: float = None, bench: dict = None) -> dict:
    """The result line of one run of a cell, as a dict; also prints each
    compared number beside its limit on standard error, last."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = manifest.load() if bench is None else bench
    cell = manifest.cell(bench, cell_name)
    cfg = manifest.config(bench, cell)
    mix = manifest.traffic(cell["traffic"])
    reads = cfg["reads"]
    dev = torch.device(device)

    torch.set_num_threads(HOST_THREADS)
    from classpp_public_torch import Class, CosmoSevereError

    library_s, built = 0.0, False
    if dev.type == "cuda":
        from classpp_public_torch.ops import cuda

        before = set(cuda.BUILD_DIR.glob("*.so"))
        t = time.perf_counter()
        cuda.library()
        library_s = time.perf_counter() - t
        built = set(cuda.BUILD_DIR.glob("*.so")) != before
        torch.cuda.reset_peak_memory_stats(dev)
    cls = Class(device=device)
    point(cls, cfg["params"], reads, dev)          # the warm-up point at the centre
    run = Run(setup_s=time.perf_counter() - t_start)

    sample = Sample(seed)
    points = traffic.points(cfg, mix, seed)
    ends = []
    with contextlib.ExitStack() as stack:
        if traced:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = stack.enter_context(torch.profiler.profile(activities=activities))
            tracer = stack.enter_context(Tracer(run, dev))
        with torch.profiler.record_function(trace.WINDOW):
            t_open = time.perf_counter()
            while True:
                params = next(points)
                try:
                    out = tracer.point(cls, params, reads) if traced \
                        else point(cls, params, reads, dev)
                    sample.offer((params, out))
                except CosmoSevereError as err:
                    run.failed += 1
                    print(f"point {run.points} refused: {err}", file=sys.stderr)
                run.points += 1
                ends.append(time.perf_counter() - t_open)
                if ends[-1] >= seconds:
                    break
            run.window_s = time.perf_counter() - t_open
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if traced:
        run.trace = trace.reduce(*trace.events(prof))
        del prof
        for name, sec in sorted(run.trace["kernel_s"].items(), key=lambda kv: -kv[1])[:20]:
            print(f"device {sec:.6f} s {name[:160]}", file=sys.stderr)
    del cls
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    for m in manifest.metrics(bench, cell_name, traced):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = card(dev)
    t_ref = time.perf_counter()
    if sample.item is None:
        ok, checks = False, {}
    else:
        params, prog_out = sample.item
        ref_out = reference.reads(params, reads, device)
        ok, checks = compare.judge(compare.numbers(prog_out, ref_out, reads), cfg["limits"])
        for _, call, part, widest, where, median in compare.parts(prog_out, ref_out):
            print(f"gap {call} {part} widest {widest!r} at {where}, median {median!r}",
                  file=sys.stderr)
    print("points (s): " + " ".join(f"{b - a:.3f}" for a, b in zip([0.0] + ends, ends)),
          file=sys.stderr)
    print(f"setup {run.setup_s:.3f} s (kernel library {library_s:.3f} s, "
          f"{'built in this run' if built else 'loaded from the checkout'}), "
          f"window {run.window_s:.3f} s of {run.points} points, "
          f"reference {time.perf_counter() - t_ref:.3f} s; card {info['kind']}, power limit "
          f"{info['power_limit']}", file=sys.stderr)
    result = {"correct": bool(ok and run.failed == 0), "attempted": run.points,
              "failed": run.failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": info["kind"], "count": cell["chips"],
                         "memory_peak_bytes": int(memory_peak)}}
    if traced:
        result["device"].update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
        result["bound_by"] = {k: sorted({by for _, by in v}) for k, v in run.work.items()}
    result["power_limit"] = info["power_limit"]
    result["setup_parts"] = {"library_s": library_s, "built": built}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["checks"] = checks
    return result

"""Reduce a profiler trace of the traced window to what the per-layer
metrics and the result's breakdown read.

`events(prof)` takes from a finished `torch.profiler.profile` the device
activities (kernels, copies, sets: name, start, end) and the benchmark's own
annotations (`bench:<stage>`, one per stage of each point, never nested);
`reduce` works on those plain tuples, so that its arithmetic is tested
without a card.
"""

from __future__ import annotations

SPAN_PREFIX = "bench:"
WINDOW = "bench-window"   # the annotation around the whole traced window
OUTSIDE = "between stages"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace, arguments and
    template arguments: `void (anonymous namespace)::perturb_ark_kernel<false,
    ...>(...)` is `perturb_ark_kernel`."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip()


def events(prof) -> tuple:
    """(device work, stage annotations, window) of a finished profiler run:
    lists of (name, start_ns, end_ns), and the WINDOW annotation's
    (start_ns, end_ns). The trace's device timeline also holds each
    annotation's device range under the annotation's name; work is every
    other device activity (kernels, copies, sets)."""
    from torch.autograd import DeviceType

    device, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith((SPAN_PREFIX, WINDOW)):
                device.append((name, e.start_ns(), e.end_ns()))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], e.start_ns(), e.end_ns()))
        elif name == WINDOW:
            window = (e.start_ns(), e.end_ns())
    if window is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW!r} annotation")
    return device, spans, window


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _segments(spans: list, w0: int, w1: int) -> list:
    """The window cut into labelled segments: each span, and OUTSIDE between
    them; spans are sorted by start and do not overlap."""
    segs, t = [], w0
    for label, a, b in spans:
        a, b = max(a, t), min(b, w1)
        if a > t:
            segs.append((OUTSIDE, t, a))
        if b > a:
            segs.append((label, a, b))
            t = b
    if t < w1:
        segs.append((OUTSIDE, t, w1))
    return segs


def _label_idle(idle: list, segs: list) -> dict:
    """Seconds of idle device time under each segment's label."""
    out, j = {}, 0
    for a, b in idle:
        while j < len(segs) and segs[j][2] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][1] < b:
            lo, hi = max(a, segs[k][1]), min(b, segs[k][2])
            if hi > lo:
                out[segs[k][0]] = out.get(segs[k][0], 0.0) + (hi - lo) * 1e-9
            k += 1
    return out


def reduce(device: list, spans: list, window: tuple, top: int = 10) -> dict:
    """busy_s (the union of device work inside the window), window_s,
    kernel_s ({short name: device seconds}), device_ops (the `top` names by
    device seconds) and idle_gaps (the `top` span labels by idle device
    seconds under them)."""
    w0, w1 = window
    clipped = [(max(a, w0), min(b, w1), n) for n, a, b in device if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in clipped])
    kernel_s = {}
    for a, b, n in clipped:
        k = short_name(n)
        kernel_s[k] = kernel_s.get(k, 0.0) + (b - a) * 1e-9
    idle, t = [], w0
    for a, b in busy:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if t < w1:
        idle.append((t, w1))
    by_label = _label_idle(idle, _segments(sorted(spans, key=lambda s: s[1]), w0, w1))
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "kernel_s": kernel_s, "device_ops": rank(kernel_s), "idle_gaps": rank(by_label)}

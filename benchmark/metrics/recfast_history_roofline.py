"""recfast_history_roofline (%): the least time the traced window's recfast_history calls
could take on the card (harness/roofline.py: their bytes over the HBM rate or
their float64 operations over the peak rate, whichever is larger, from the
calls' shapes and counts) over the kernel's device time in the profiler's
trace. Nothing where the trace holds no such kernel."""

KERNEL = "recfast_history_kernel"


def read(run):
    spent = (run.trace or {}).get("kernel_s", {}).get(KERNEL, 0.0)
    calls = run.work.get(KERNEL, [])
    if spent <= 0.0 or not calls:
        return None
    return 100.0 * sum(s for s, _ in calls) / spent

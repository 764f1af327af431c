"""setup_s (s): from the start of the process to the opening of the window:
imports, the kernel library's load (its build on a checkout's first run) and
the warm-up point at the configuration's centre."""


def read(run):
    return run.setup_s

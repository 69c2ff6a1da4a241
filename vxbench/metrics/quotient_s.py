"""Per-layer metric quotient_s: seconds a job's prove spends in its phases
aux, quotient (``prove(timer=)``), summed over the window's jobs, over
their count."""

from vxbench.metrics._phases import phases


def read(run):
    return phases(run, ("aux", "quotient"))

"""Per-layer metric lde_s: seconds a job's prove spends in its phases
lde (``prove(timer=)``), summed over the window's jobs, over
their count."""

from vxbench.metrics._phases import phases


def read(run):
    return phases(run, ("lde",))

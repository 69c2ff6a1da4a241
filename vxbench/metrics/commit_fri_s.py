"""Per-layer metric commit_fri_s: seconds a job's prove spends in its phases
commit, fri, queries (``prove(timer=)``), summed over the window's jobs, over
their count."""

from vxbench.metrics._phases import phases


def read(run):
    return phases(run, ("commit", "fri", "queries"))

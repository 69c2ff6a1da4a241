"""Per-layer metric verify_s.shards: the verify seconds a job in a traced
run (host clock, each verify span ending in a synchronize), summed over
the window's whole jobs, over their count. The cells whose verify runs
too unsteadily for an end-to-end bound read it here."""

from vxbench.metrics._phases import per_job


def read(run):
    return per_job(run, lambda j: j.spans["verify"].seconds)

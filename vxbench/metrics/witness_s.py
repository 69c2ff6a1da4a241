"""Per-layer metric witness_s: seconds a job spends building its witness
(the AIR's ``make_trace`` or ``make_trace_vec``, ending in a
synchronize), summed over the window's jobs, over their count."""

from vxbench.metrics._phases import per_job


def read(run):
    return per_job(run, lambda j: j.spans["witness"].seconds)

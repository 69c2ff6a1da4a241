"""Per-layer metric verify_kernels_per_job: kernels the profiler saw in a
job's verify span (copies and fills left out), summed over the window's
jobs, over their count."""

from vxbench.metrics._phases import per_job


def read(run):
    return per_job(run, lambda j: j.spans["verify"].kernels())

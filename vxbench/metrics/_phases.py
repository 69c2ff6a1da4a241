"""Shared arithmetic of the per-layer readers: sums over the window's
whole jobs, over their count."""


def traced(run):
    return [j for j in run.jobs if j.spans]


def per_job(run, value):
    jobs = traced(run)
    if not jobs:
        return None
    return sum(value(j) for j in jobs) / len(jobs)


def phases(run, names):
    """Seconds of the prove's phases ``names`` (``prove(timer=)``, a
    synchronize at each phase end), per job."""
    return per_job(run, lambda j: sum(j.spans["prove"].phases.get(n, 0.0)
                                      for n in names))

"""Per-layer metric prove_idle_pct: the share of the prove spans' host
time in which no operation ran on the device, 100 (1 - busy / span),
with busy the union of the spans' device intervals, summed over the
window's jobs."""

from vxbench.metrics._phases import traced


def read(run):
    spans = [j.spans["prove"] for j in traced(run)]
    total = sum(sp.seconds for sp in spans)
    if not spans or total <= 0:
        return None
    return 100.0 * (1.0 - sum(sp.busy_s() for sp in spans) / total)

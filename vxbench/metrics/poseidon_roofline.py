"""Per-layer metric poseidon_roofline: the share of its roofline that the
hand-written Poseidon kernels (csrc/poseidon.cu) reach inside the prove
spans: the least time the card needs for the permutations the proofs'
shapes ask for (``vxbench/roofline.py``, at the card's highest SM
clock), over the profiler's device time of those kernels, summed over
the window's jobs. Nothing to read when the profiler saw none of them."""

from vxbench.metrics._phases import traced
from vxbench.roofline import prove_bound_s
from vxbench.trace import POSEIDON_KERNEL


def read(run):
    jobs = traced(run)
    measured = sum(j.spans["prove"].device_s(POSEIDON_KERNEL) for j in jobs)
    if not jobs or measured <= 0 or not run.sm_mhz:
        return None
    bound = sum(prove_bound_s(run.shape, run.guarantee, run.nonces[j.index],
                              run.sm_mhz) for j in jobs)
    return 100.0 * bound / measured

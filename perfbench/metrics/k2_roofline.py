"""k2_roofline: K2's least time on the traced iterations' blended work
(the mean over them) over its mean device time per launch in the traced
stretch, in % (``harness.work``)."""
from harness import work

KERNEL = "tile_backward_kernel"


def read(ctx):
    r = ctx.res
    if r.capture is None or not r.work or not r.capture.count(KERNEL):
        return None
    per_call = sum(r.capture.totals(KERNEL).values()) / r.capture.count(
        KERNEL)
    least = sum(work.least_seconds(*work.k2_work(w))
                for w in r.work) / len(r.work)
    return 100.0 * least / per_call

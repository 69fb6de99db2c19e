"""k1_roofline.render: K1's least time on the traced frames' blended
work (the mean over them) over its mean device time per launch in the
traced stretch, in % (``harness.work``)."""
from harness import work

KERNEL = "tile_forward_kernel"


def read(ctx):
    r = ctx.res
    if r.capture is None or not r.work or not r.capture.count(KERNEL):
        return None
    per_call = sum(r.capture.totals(KERNEL).values()) / r.capture.count(
        KERNEL)
    least = sum(work.least_seconds(*work.k1_work(w))
                for w in r.work) / len(r.work)
    return 100.0 * least / per_call

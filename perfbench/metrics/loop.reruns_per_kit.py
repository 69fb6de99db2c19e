"""loop.reruns_per_kit: overflow re-runs (``TrainLog.events`` of kind
``overflow``) per 1,000 of the window's iterations."""


def read(ctx):
    if getattr(ctx.res, "overflows", None) is None or not ctx.res.units:
        return None
    return 1e3 * ctx.res.overflows / ctx.res.units

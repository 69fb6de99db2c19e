"""launches_per_it.train: the card's kernel, copy and fill events in the
traced stretch, per iteration."""


def read(ctx):
    cap = ctx.res.capture
    if cap is None or not cap.device or not ctx.res.trace_units:
        return None
    return cap.count() / ctx.res.trace_units

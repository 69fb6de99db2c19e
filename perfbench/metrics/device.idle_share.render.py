"""device.idle_share.render: 1 − (the card's busy time per frame in
the traced stretch) / (the untraced window's wall per frame), in %."""


def read(ctx):
    r = ctx.res
    if r.capture is None or not r.capture.device or not r.trace_units:
        return None
    busy = r.capture.busy_seconds() / r.trace_units
    return 100.0 * (1.0 - busy / (r.window_s / r.units))

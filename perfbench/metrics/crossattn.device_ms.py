"""crossattn.device_ms: the card's time inside the range
``step/crossattn`` per phase-2 iteration of the traced stretch, in ms."""


def read(ctx):
    r = ctx.res
    if r.capture is None or not r.capture.device or not r.phase2_units:
        return None
    return 1e3 * r.capture.seconds_under("step/crossattn") / r.phase2_units

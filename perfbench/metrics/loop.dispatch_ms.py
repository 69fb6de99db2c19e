"""loop.dispatch_ms: the mean host time ``train_scene`` took to launch an
iteration (``TrainLog.iter_times``) over the window's iterations, in ms."""


def read(ctx):
    xs = getattr(ctx.res, "dispatch_s", None)
    if not xs:
        return None
    return 1e3 * sum(xs) / len(xs)

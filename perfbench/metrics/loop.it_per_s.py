"""loop.it_per_s: the committed ``train_scene`` iterations of the
untraced window over its wall on the host's clock, first callback after
warm-up to the first callback ``--seconds`` later; overflow re-runs and
densifications inside count as time."""


def read(ctx):
    r = ctx.res
    if getattr(r, "kind", None) != "train" or not r.units:
        return None
    return r.rate

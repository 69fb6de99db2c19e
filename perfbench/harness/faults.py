"""Faults planted under the timed path, to see each cell's comparison
fail: ``unchanged`` (a training step that leaves the state as it was),
``half_batch`` (a step whose loss is the mean over half of the view's
pixels), ``no_stats`` (a step that gathers no densification statistics),
``no_densify`` (a densification that returns the anchors as they were)
and ``altered`` (every rendered frame's colour raised by one 8-bit level
where it is made)."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(name: str):
    import gscream_tpu_torch.train.loop as loop
    import gscream_tpu_torch.train.render_sets as rs
    import gscream_tpu_torch.train.step as step
    saved = []

    def patch(mod, attr, value):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, value)

    if name == "unchanged":
        patch(step, "apply_adam", lambda *a, **k: None)
    elif name == "half_batch":
        orig = step.loss_terms

        def half(out, gt_image, gt_mask, midas_depth, fg_box_mask, opt,
                 is_ref):
            h = out.color.shape[0] // 2
            cut = type(out)(*(x[:h] for x in out))
            return orig(cut, gt_image[:, :h], gt_mask[:, :h],
                        midas_depth[:, :h], fg_box_mask[:h], opt, is_ref)
        patch(step, "loss_terms", half)
    elif name == "no_stats":
        patch(step, "accumulate_stats", lambda stats, *a: stats)
    elif name == "no_densify":
        patch(loop, "adjust_anchors",
              lambda state, stats, m, v, *a, **k: (state, stats, m, v))
    elif name == "altered":
        orig_make = rs.make_render_fn

        def make(*a, **k):
            render = orig_make(*a, **k)

            def altered(params, mlps, cam):
                out, visible, demand = render(params, mlps, cam)
                return (out._replace(color=out.color + 1.0 / 255.0),
                        visible, demand)
            return altered
        patch(rs, "make_render_fn", make)
    else:
        raise ValueError(f"no fault {name!r}")
    try:
        yield
    finally:
        for mod, attr, value in reversed(saved):
            setattr(mod, attr, value)

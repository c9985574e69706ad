"""A step's model FLOPs (``portbench/flops.py``) times the units of the
traced window, over the window's seconds, as a percentage of the peak of
the cell's compute dtype."""


def read(trace, ctx, spec, peaks):
    if trace.window_s <= 0 or not ctx.get("units") or "model_flops" not in ctx:
        return None
    return 100.0 * ctx["model_flops"] * ctx["units"] / trace.window_s / ctx["peak_flops"]

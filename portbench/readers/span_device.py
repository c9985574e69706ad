"""Device ms a unit of the program's span ``spec["span"]``: the stream time
between each in-window instance's two CUDA events (``utils/debug.records``,
idle inside the span included), summed over the window's units."""

from portbench.readers.span_count import window_records


def read(trace, ctx, spec, peaks):
    recs = window_records(trace, spec["span"])
    if not recs or not ctx.get("units") or any(r["device_ms"] is None for r in recs):
        return None
    return sum(r["device_ms"] for r in recs) / ctx["units"]

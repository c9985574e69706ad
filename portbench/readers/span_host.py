"""Host ms a unit inside the program's span ``spec["span"]``: each
in-window instance's host start to end (``utils/debug.records``), summed
over the window's units."""

from portbench.readers.span_count import window_records


def read(trace, ctx, spec, peaks):
    recs = window_records(trace, spec["span"])
    if not recs or not ctx.get("units"):
        return None
    return sum(r["host_ms"] for r in recs) / ctx["units"]

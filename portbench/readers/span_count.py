"""Instances of the program's span ``spec["span"]`` a unit: those whose
host start lies inside the window (``user_annotation`` events of the
trace), over the window's units. None where the window holds no
``msl.step`` (a program without spans); the helpers below serve the other
span readers."""

STEP_SPAN = "msl.step"


def instances(trace, name: str) -> int:
    """The window's instances of span ``name``."""
    return sum(1 for n, a, _, _ in trace.host if n == name and trace.t0 <= a <= trace.t1)


def window_records(trace, name: str) -> list[dict] | None:
    """The program's records of the window's instances of ``name``: as many
    newest records of its ring as the window holds instances (the readers
    run right after the window, and the warm-up unit runs before it); None
    without instances, or where the program keeps no such records."""
    n = instances(trace, name)
    if not n:
        return None
    try:
        from maxsquareloss_torch.utils.debug import records
    except ImportError:
        return None
    recs = records(name, n)
    return recs if len(recs) == n else None


def read(trace, ctx, spec, peaks):
    if not ctx.get("units") or not instances(trace, STEP_SPAN):
        return None
    return instances(trace, spec["span"]) / ctx["units"]

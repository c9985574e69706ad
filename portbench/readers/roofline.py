"""The least time of a piece of work over the device time of the kernels
that do it, as a percentage.

``spec["work"]`` names the work in the driver's ``work()`` (its launches a
unit as (FLOP, bytes), and the peak FLOP/s that applies); the least time
of each launch is the larger of its FLOP over that peak and its bytes over
the memory bandwidth (``peaks.json``), times the units of the window.
``spec["kernels"]`` lists substrings of the kernels' names; without a
matching kernel in the window there is nothing to read."""

from portbench.flops import bound_seconds


def read(trace, ctx, spec, peaks):
    work = ctx.get(spec["work"])
    seconds = trace.device_time(spec["kernels"])
    if work is None or seconds <= 0 or not ctx.get("units"):
        return None
    bound = bound_seconds(work["launches"], work["peak_flops"], peaks["bytes_per_s"])
    return 100.0 * bound * ctx["units"] / seconds

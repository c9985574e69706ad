"""The share of the traced window in which no operation ran on the device
(one minus the union of the device operations' intervals), as a
percentage."""


def read(trace, ctx, spec, peaks):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

"""Readers of per-layer metrics: ``read(trace, ctx, spec, peaks)`` returns
the metric's value, or None where the trace holds nothing to read.
``ctx`` is the driver's ``work()`` with ``units``, the units that ran in
the traced window; ``spec`` the metric's ``metrics/<name>.json`` merged
with its ``BENCHMARK.json`` entry; ``peaks`` is ``peaks.json``."""

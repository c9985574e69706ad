"""Device ms a unit in which the kernels that ``spec["kernels"]`` names
(substrings of their names) run and no other device operation does: the
union of their intervals less the union of every other operation's, over
the window's units. None where none of them ran in the window."""

from portbench.trace import union


def exposed_us(mine, others) -> float:
    """The length of ``mine``'s union outside ``others``' union."""
    total, cover = 0.0, union(others)
    for a, b in union(mine):
        total += b - a
        for c, d in cover:
            if c >= b:
                break
            total -= max(0.0, min(b, d) - max(a, c))
    return total


def read(trace, ctx, spec, peaks):
    named = [any(p in name for p in spec["kernels"]) for name, _, _ in trace.device]
    mine = [(a, b) for (_, a, b), m in zip(trace.device, named) if m]
    if not mine or not ctx.get("units"):
        return None
    others = [(a, b) for (_, a, b), m in zip(trace.device, named) if not m]
    return exposed_us(mine, others) * 1e-3 / ctx["units"]

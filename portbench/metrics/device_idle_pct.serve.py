"""device_idle_pct.serve (%; layer: the device; moves serve_pages_per_s).

1 minus the union of the device's operations (kernels, copies, fills)
over the profiled window's length, both read from the profiler's trace."""

FAMILIES = ()


def read(ctx):
    tr = ctx.trace
    if tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

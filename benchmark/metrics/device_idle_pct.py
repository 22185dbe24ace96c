"""Share of the traced stretch of whole trains in which no device
operation ran (the profiler's timeline: 1 - busy / window)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace.device_events == 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

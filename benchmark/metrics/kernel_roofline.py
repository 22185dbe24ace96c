"""Share of the roofline of the halves' device work: the least seconds
of the traced iterations' halves (``_roofline``: the larger of their
operations at the peaks and their bytes at the HBM rate, counted from
the ratings and the rank) over the device time inside the halves (the
union of every kernel, copy and fill the profiler saw in them)."""

from benchmark.metrics import _roofline


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace.half_device_s <= 0:
        return None
    work = _roofline.iteration_work(ctx["shape"])
    least = _roofline.least_seconds(work, ctx["precision"])
    return 100.0 * least * ctx["trace_iterations"] / trace.half_device_s

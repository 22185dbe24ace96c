"""The whole iteration's share of the card's peak: the least seconds of
an iteration's model operations at the peaks its precision allows
(``_roofline``: Gram triangle and right-hand sides on the tensor cores,
the solves on the CUDA cores) over the window's measured seconds per
iteration (host clock, every train whole)."""

from benchmark.metrics import _roofline


def read(ctx):
    if ctx.get("platform") != "gpu":
        return None
    w = ctx["window"]
    work = _roofline.iteration_work(ctx["shape"])
    least = _roofline.ops_seconds(work, ctx["precision"])
    return 100.0 * least / (w["seconds"] / w["iterations"])

"""Hand-written kernel launches per iteration over the window: the
port's own launch counters (``ops._build.LAUNCHES``, every kernel
wrapper) summed, over the window's iterations.  0 on a path that
launches no hand-written kernel."""


def read(ctx):
    w = ctx["window"]
    return w["launches"] / w["iterations"]

"""Ratings trained per second: the ratings times the iterations of all
the window's trains, over the window's seconds from its start to the
end of its last train (host clock)."""


def read(ctx):
    w = ctx["window"]
    return ctx["shape"]["nnz"] * w["iterations"] / w["seconds"]

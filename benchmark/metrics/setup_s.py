"""Seconds from the process's start to the first timed train: the
imports and the card's start, the ratings made from the seed, the
kernels built or loaded, the trainer staged, one warm train (host
clock)."""


def read(ctx):
    return ctx["setup_s"]

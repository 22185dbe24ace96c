"""The trainer's own fenced staging seconds
(``ALSTrainer.staging_seconds``): the COO grouped by row into the
bucket layout on both sides and moved to the device."""


def read(ctx):
    return ctx["staging_s"]

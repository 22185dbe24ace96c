"""Mean fenced item-half milliseconds over the window's trains, from
the trainer's ``half_seconds`` (each half ends in a device
synchronise)."""


def read(ctx):
    halves = [s for name, s in ctx["window"]["half_seconds"]
              if name == "item"]
    if not halves:
        return None
    return 1e3 * sum(halves) / len(halves)

"""Share of the traced stretch's wall time in which no operation ran on
the device: 1 − (the union of the device operations' intervals in the
profiler's trace, overlaps counted once) over the stretch's wall time,
whole decode steps from a step's start to the greedy tokens on the host.
Not clamped: a busy time counted above the wall reads below 0."""

UNIT, LAYER, MOVES = "%", "device", "decode_tok_s"


def read(ctx):
    if ctx.wall_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.wall_s)

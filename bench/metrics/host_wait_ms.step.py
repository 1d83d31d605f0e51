"""The device's wait for the host between decode steps, from the program's
own records: the mean gap from one replay's end event to the next replay's
start event (the greedy tokens' copy back, the serve loop, the next
token's copy in), less the part of it in which the program's `obs.resolve`
span was open, over the program-traced stretch (`bench/program_trace.py`;
no profiler attached)."""

from bench import program_trace

UNIT, LAYER, MOVES = "ms", "serve loop", "itl_ms_p95"


def read(ctx):
    reps = program_trace.decode_replays(ctx)
    if reps is None:
        return None
    return program_trace.host_wait_ms(reps, ctx.program["records"])

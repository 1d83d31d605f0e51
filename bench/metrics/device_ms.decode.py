"""Device time of a decode step's graph replay, from the program's own
records: the mean of `dev_t1 - dev_t0` over the program-traced stretch's
replays of the unmarked graph (the one every untraced step replays),
between the timing events the compiled step records just before and just
after `graph.replay()` (`bench/program_trace.py`; no profiler attached)."""

from bench import program_trace

UNIT, LAYER, MOVES = "ms", "model step", "decode_tok_s"


def read(ctx):
    reps = program_trace.decode_replays(ctx, marked=False)
    return None if reps is None else program_trace.device_ms(reps)

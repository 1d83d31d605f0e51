"""Device time a decode replay spends inside the reuse site calls, every
site and layer: the sum of the segments between each call's entry and exit
marks (timing events recorded inside the decode graph), mean over the
program-traced stretch's replays of the marked graph
(`bench/program_trace.py`). Each of a call's three segments holds one
mark's own cost (the marks drain the card's pipeline)."""

from bench import program_trace

UNIT, LAYER, MOVES = "ms", "reuse engine", "decode_tok_s"


def read(ctx):
    reps = program_trace.decode_replays(ctx, marked=True)
    phases = None if reps is None else program_trace.phase_ms(reps)
    return None if phases is None else program_trace.site_ms(phases)

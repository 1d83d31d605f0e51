"""The `epilogue` phase of `site_ms.decode`: device time a decode replay
spends in the site calls after their ΔW product returns (the prev_out
copy, the bias add and the cast), every site and layer, mean over the
program-traced stretch's replays of the marked graph
(`bench/program_trace.py`); one mark's own cost a call included."""

from bench import program_trace

UNIT, LAYER, MOVES = "ms", "reuse engine", "decode_tok_s"


def read(ctx):
    reps = program_trace.decode_replays(ctx, marked=True)
    phases = None if reps is None else program_trace.phase_ms(reps)
    if phases is None:
        return None
    return program_trace.site_ms(phases, ("epilogue",))

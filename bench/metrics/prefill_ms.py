"""Device time of a cohort's prefill (CUDA events around
`CompiledStep.prefill`), mean over the window's cohorts."""

UNIT, LAYER, MOVES = "ms", "compiled step prefill", "decode_tok_s"


def read(ctx):
    if not ctx.prefill_ms:
        return None
    return sum(ctx.prefill_ms) / len(ctx.prefill_ms)

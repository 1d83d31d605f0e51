"""The decode step's share of the card's bf16 peak: the FLOPs the
stretch's steps need (`cost.step_work`: every reuse site at the tiles it
computed, the other weights, the head, attention or WKV) over its wall time
× 989e12."""

from bench import cost

UNIT, LAYER, MOVES = "%", "model step", "decode_tok_s"


def read(ctx):
    if ctx.steps <= 0 or ctx.wall_s <= 0:
        return None
    flops, _ = cost.step_work(ctx.conf,
                              {k: v[1] for k, v in ctx.stretch_tiles.items()},
                              ctx.steps, ctx.mix["batch"], ctx.kv_len)
    return 100.0 * flops / (ctx.wall_s * cost.PEAK_FLOPS)

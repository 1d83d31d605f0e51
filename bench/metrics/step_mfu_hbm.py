"""The decode step's share of the card's HBM bandwidth: the bytes the
stretch's steps need (`cost.step_work`: the weights of the tiles computed,
the other weights, the KV cache or WKV state read) over its wall time ×
3.35e12 B/s."""

from bench import cost

UNIT, LAYER, MOVES = "%", "model step", "decode_tok_s"


def read(ctx):
    if ctx.steps <= 0 or ctx.wall_s <= 0:
        return None
    _, byt = cost.step_work(ctx.conf,
                            {k: v[1] for k, v in ctx.stretch_tiles.items()},
                            ctx.steps, ctx.mix["batch"], ctx.kv_len)
    return 100.0 * byt / (ctx.wall_s * cost.PEAK_BYTES)

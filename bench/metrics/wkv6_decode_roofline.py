"""The WKV6 decode step's share of its roofline in the traced stretch
(read where it ran: the rwkv6 cells): the bytes of `cost.wkv6_bytes`, one call a layer a step, over
3.35e12 B/s, over the device time of `csrc/wkv6_decode.cu`'s
`wkv6_decode_kernel`."""

from bench import cost

UNIT, LAYER, MOVES = "%", "kernels", "decode_tok_s"
KERNELS = ("wkv6_decode_kernel",)


def read(ctx):
    t = ctx.device_seconds(KERNELS)
    if t is None:
        return None
    byt = cost.wkv6_bytes(ctx.conf, ctx.steps * ctx.conf["n_layers"],
                          ctx.mix["batch"])
    return 100.0 * cost.least_seconds(0.0, byt) / t

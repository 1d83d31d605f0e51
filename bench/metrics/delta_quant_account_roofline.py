"""The fused delta/quant/account kernel's share of its roofline in the
traced stretch: the bytes of `cost.delta_quant_bytes` at every site call
over 3.35e12 B/s, over the device time of `csrc/delta_quant.cu`'s
`delta_quant_account_kernel`."""

from bench import cost

UNIT, LAYER, MOVES = "%", "kernels", "decode_tok_s"
KERNELS = ("delta_quant_account_kernel",)


def read(ctx):
    t = ctx.device_seconds(KERNELS)
    if t is None:
        return None
    byt = sum(cost.delta_quant_bytes(s, ctx.steps * s.layers,
                                     ctx.mix["batch"])
              for s in cost.sites(ctx.conf))
    return 100.0 * cost.least_seconds(0.0, byt) / t

"""The ΔW GEMMs' share of their roofline in the traced stretch: the least
time the computed tiles need (their weights and Δ rows read, prev_out read
and the output written, `cost.gemm_work`) over the device time of the
kernels below (the output-stationary, input-stationary and ragged instances
of `csrc/reuse_tile.cuh`'s `cluster_gemm`)."""

from bench import cost

UNIT, LAYER, MOVES = "%", "kernels", "decode_tok_s"
KERNELS = ("cluster_gemm",)


def read(ctx):
    t = ctx.device_seconds(KERNELS)
    if t is None:
        return None
    flops = byt = 0.0
    for s in cost.sites(ctx.conf):
        f, b = cost.gemm_work(s, ctx.stretch_tiles[s.name][1],
                              ctx.steps * s.layers, ctx.mix["batch"])
        flops += f
        byt += b
    return 100.0 * cost.least_seconds(flops, byt) / t

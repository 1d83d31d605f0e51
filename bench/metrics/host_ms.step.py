"""Host time of a decode call: from a step's start until
`CompiledStep.decode` returns (the token copied into the buffer, the budget
lanes synced, the graph replay launched), mean over the window's steps."""

UNIT, LAYER, MOVES = "ms", "serve loop", "itl_ms_p95"


def read(ctx):
    if not ctx.host_ms:
        return None
    return sum(ctx.host_ms) / len(ctx.host_ms)

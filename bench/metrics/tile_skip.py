"""Share of the reuse sites' weight tiles skipped in the window: skipped
tiles over all tiles, every site and layer, from the program's sensor
counters (`ReuseEngine.sensor_report`) read before and after the window."""

UNIT, LAYER, MOVES = "%", "reuse engine", "decode_tok_s"


def read(ctx):
    skipped = sum(s for s, _ in ctx.window_tiles.values())
    total = skipped + sum(c for _, c in ctx.window_tiles.values())
    if total <= 0:
        return None
    return 100.0 * skipped / total

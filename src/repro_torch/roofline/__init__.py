"""repro_torch.roofline — the card's peak rates (`model_cost`).

The reference's analytic per-cell roofline model is not ported yet; only
the constants the sensor's cost model prices with are here.
"""

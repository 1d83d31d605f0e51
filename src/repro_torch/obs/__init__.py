"""repro_torch.obs — the correlation ids of the event stream (`events`).

The rest of the reference's observability plane (spans, metrics, export,
the measured-latency table, fleet views) is not ported yet.
"""

"""repro_torch.roofline — the analytic roofline model and its checks.

`model_cost` prices a step (per-cell FLOPs, HBM bytes and collective bytes)
and one reuse GEMM (the kernel work model) at the H100 SXM5's datasheet
rates; `validate` holds those prices against a measured count or sweep;
`collectives` is the sharded serve's no-gather check.
"""

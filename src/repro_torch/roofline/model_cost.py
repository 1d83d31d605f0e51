"""Hardware constants of the card the port runs on.

The reference's `repro.roofline.model_cost` prices with TPU v5e figures
(197 TFLOP/s bf16, 819 GB/s HBM). The port runs on an NVIDIA H100 SXM5 80 GB,
so these are that card's, from NVIDIA's H100 Tensor Core GPU datasheet:
dense BF16 tensor-core peak 989 TFLOP/s (1,979 with sparsity) and HBM3
bandwidth 3.35 TB/s. They are datasheet peaks, not measurements. The rest of
the reference's module (the per-cell FLOP, byte and collective model) is not
ported yet.
"""

PEAK_FLOPS = 989e12   # H100 SXM5 dense BF16 tensor-core FLOP/s (datasheet)
HBM_BW = 3.35e12      # H100 SXM5 HBM3 bytes/s (datasheet)

from repro_torch.quant.quantize import (
    INT8_MAX,
    INT8_MIN,
    QuantSpec,
    calibrate_scale,
    dequantize_int8,
    fake_quantize,
    quantize_int8,
)

__all__ = [
    "INT8_MAX",
    "INT8_MIN",
    "QuantSpec",
    "calibrate_scale",
    "dequantize_int8",
    "fake_quantize",
    "quantize_int8",
]

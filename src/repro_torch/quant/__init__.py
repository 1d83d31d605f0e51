from repro_torch.quant.quantize import (
    INT8_MAX,
    INT8_MIN,
    dequantize_int8,
    quantize_int8,
)

__all__ = ["INT8_MAX", "INT8_MIN", "dequantize_int8", "quantize_int8"]

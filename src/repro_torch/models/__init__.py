from repro_torch.models.transformer import (
    forward,
    init_decode_state,
    init_params,
    output_logits,
    params_from_numpy,
)

__all__ = ["forward", "init_decode_state", "init_params", "output_logits",
           "params_from_numpy"]

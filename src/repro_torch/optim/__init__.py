from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.compression import compress_with_feedback, decompress
from repro_torch.optim.schedules import constant, linear_warmup_cosine

__all__ = [
    "AdamWConfig", "adamw_update", "init_opt_state",
    "compress_with_feedback", "decompress",
    "constant", "linear_warmup_cosine",
]

from repro_torch.ckpt.checkpoint import (
    AsyncCheckpointer,
    gc_checkpoints,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.ckpt.recovery import LoopConfig, ResilientLoop

__all__ = [
    "AsyncCheckpointer", "LoopConfig", "ResilientLoop", "gc_checkpoints",
    "latest_step", "restore_checkpoint", "save_checkpoint",
]

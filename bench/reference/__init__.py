"""The plain references the benchmark holds the program's served tokens
against, and the comparison that decides `correct`.

Plain PyTorch only: nothing here imports the program, JAX or the JAX
package. Each family's `logits(params, cfg, tokens, n_prompt, prec)`
(`reference/<family>.py`, found through `families/<family>.py`) takes the benchmark's own weights and configuration file (a dict).
"""

from __future__ import annotations

import torch

from bench import families
from bench.reference.common import PRECISIONS


def logits(params: dict, cfg: dict, tokens: torch.Tensor, n_prompt: int, *,
           precision: str = "bf16") -> torch.Tensor:
    """The reference's f32 logits at the positions that served a token
    ([B, T - n_prompt + 1, V]), its products in `precision` (a key of
    `common.PRECISIONS`: "bf16", the configuration's; "fp8", the control,
    the precision below it)."""
    fn = families.load(cfg["reference"]).logits
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return fn(params, cfg, tokens, n_prompt, PRECISIONS[precision])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def served_gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best logit each served token's logit
    lies: ref [B, P, V] f32, served [B, P] token ids; returns [B, P] f32
    (0 where the served token is the reference's greedy choice)."""
    best = ref.amax(dim=-1)
    got = ref.gather(-1, served.long().to(ref.device)[..., None])[..., 0]
    return best - got

"""The benchmark's weights: drawn on the device from the run's seed, in the
dtype they are served in, one call a stacked leaf, in the layout the
program's models read (`params["blocks"]["attn"]["wqkv"]` is [L, d, q+2kv];
rwkv6's `params["blocks"]["rwkv"]["tmix"]["wr"]` is [L, d, d]), which each
family's `make_weights` lays out.

Both sides get these same tensors: the program serves them, and the
reference reads them once the window has closed. Scales: normal/sqrt(fan_in)
for every projection, 0.01 for the embedding and the second LoRA factors;
norm scales N(0, 0.1²) (a norm multiplies by 1 + scale).
"""

from __future__ import annotations

import math

import torch

from bench import families


class Draw:
    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed % 2**63)

    def normal(self, *shape, std: float, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=dtype)
        return t.mul_(std)

    def dense(self, lead: tuple, fan_in: int, fan_out: int):
        return self.normal(*lead, fan_in, fan_out, std=1 / math.sqrt(fan_in))

    def uniform(self, *shape, lo: float, hi: float):
        t = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=torch.float32)
        return t.mul_(hi - lo).add_(lo)

    def norm(self, *shape):
        return {"scale": self.normal(*shape, std=0.1, dtype=torch.float32)}


@torch.no_grad()
def make(cfg: dict, seed: int, device) -> dict:
    """The weights of configuration `cfg` (its file, as a dict) for `seed`,
    in the layout of its family (`families/<cfg["reference"]>.py`)."""
    return families.load(cfg["reference"]).make_weights(cfg,
                                                        Draw(seed, device))

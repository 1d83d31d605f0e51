"""ReuseSense on PyTorch and CUDA (Hopper).

The second package of the repository: it mirrors `repro`'s module layout and
is held against it by the `tests/test_torch_*.py` parity tests. It imports
torch, numpy and the standard library only. Every kernel of the reuse decode
path is CUDA C++ under `csrc/`, built at first use (see `kernels/backend.py`);
each has a plain PyTorch twin in the same module, which the wrapper takes for
CPU tensors.
"""

# the core first: its engine imports the kernels, which import its leaves
from repro_torch import core  # noqa: E402,F401

"""Device and dtype policy of the port.

All state is float32, like the reference (its f32 accumulators are kept in
range by the `stats_scale` and `rf_scale` reparameterisations); the deposit
kernels of trees and large grids sum their RF in float64 and round it once. The port runs
no matrix product or convolution on its hot path, so TF32 never enters a
result.

Entry points run on the card unless the caller asks for the CPU: no device
given means CUDA, and CUDA where there is none raises. Nothing falls back to
the CPU by itself.
"""

from __future__ import annotations

import torch

DTYPE = torch.float32


def resolve(device=None) -> torch.device:
    """The torch.device a caller named, CUDA when none is named; raises if
    that means an absent GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def require_cuda() -> None:
    """Raise unless a CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this run needs an NVIDIA GPU "
                           "and a CUDA build of PyTorch (pass device='cpu' to "
                           "run on the CPU)")

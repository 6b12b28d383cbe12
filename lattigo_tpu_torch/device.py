"""Device policy of the port: entry points run on the GPU by default."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the CUDA device and raises when there is none; nothing
    carries on silently on the CPU.  Callers that want the CPU say so."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)

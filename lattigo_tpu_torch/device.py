"""Device policy of the port: entry points run on the GPU by default."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the CUDA device and raises when there is none; nothing
    carries on silently on the CPU.  Callers that want the CPU say so.  A
    CUDA device always comes back with its index (``"cuda"`` is the current
    device), so it equals the device of the tensors made on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device

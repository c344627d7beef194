"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    no GPU is present, instead of silently running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


def device_vector(values, dtype, device) -> torch.Tensor:
    """A short vector of host constants made on ``device`` by fill kernels:
    a copy from the host (``torch.tensor(..., device=...)``) waits for the
    device, which a step must not do."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device) for v in values])

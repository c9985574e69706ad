"""Device resolution for the port's entry points (counterpart of
``maxsquareloss_tpu/utils/runtime.py``'s process-level knobs).

There is no silent CPU fallback: a caller that names no device gets the
card, and an error when there is none.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda`` (raises if CUDA is absent); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "plain PyTorch path on the host"
            )
        return torch.device("cuda")
    return torch.device(device)

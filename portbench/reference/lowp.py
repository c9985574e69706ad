"""The reference's precision and the lower-precision controls of the output
check: the reference computed one step below the precision a cell states.
float32 with TF32 off has TF32 below it (``set_tf32(True)``); bfloat16 has
fp8 below it: ``fp8_e4m3`` rounds a conv's input and weight to float8 e4m3
with a per-tensor scale (the largest |value| to 448), and passes the
gradient through unchanged."""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def set_tf32(on: bool) -> None:
    """TF32 for cuDNN convs and cuBLAS matmuls: off for a float32 reference."""
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    d = t.detach()
    scale = FP8_MAX / d.abs().amax().clamp_min(1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).to(d.dtype) / scale
    return t + (q - d) if t.requires_grad else q


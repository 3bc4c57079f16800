"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. They never
fall back to the CPU quietly: without CUDA, a call that did not ask for the
CPU raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; raises when CUDA is absent.
    An explicit device (``"cpu"``, ``"cuda:0"``, a ``torch.device``) is
    returned as given, after the same check for a CUDA request."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        set_f32_precision()
    return dev


def set_f32_precision() -> None:
    """Full float32 on the card: no TF32 in matmuls or cuDNN convolutions.
    The JAX reference pins Precision.HIGHEST on every contraction."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

"""Device selection for entry points (counterpart of kungfu_tpu's
``utils/platform.py``).

Entry points run on ``cuda`` unless the caller asks for the CPU.  A
missing CUDA device is an error, never a quiet fall-back to the CPU: a
number measured on the CPU must not pass for a GPU one.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def full_fp32_matmuls() -> None:
    """Turn TF32 off for float32 matrix products and convolutions.

    The f32 LM head and the f32 paged-attention path need full f32 (the
    JAX package asks for ``Precision.HIGHEST`` there); TF32 keeps about
    three decimal digits.  PyTorch's default already leaves matmul TF32
    off but cuDNN's on, so both are set explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` means ``cuda``.  Raises ``RuntimeError`` when a CUDA
    device is asked for (or defaulted to) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    full_fp32_matmuls()
    return dev


def default_dtype(device: torch.device, dtype: Optional[torch.dtype] = None
                  ) -> torch.dtype:
    """The model dtype: bf16 on the card, f32 on the CPU (as the JAX CLI
    picks bf16 on the TPU and f32 elsewhere), unless given."""
    if dtype is not None:
        return dtype
    return torch.bfloat16 if device.type == "cuda" else torch.float32

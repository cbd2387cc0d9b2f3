"""Device resolution: the counterpart of the JAX package's
``utils/jaxenv.py``.

Every entry point takes an explicit device and defaults to the card.
Asking for CUDA where there is none raises: nothing here moves to the
CPU unless the caller says ``"cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``); raises
    RuntimeError when CUDA is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type: {dev.type}")
    return dev


def configure_numerics() -> None:
    """Full-precision matmuls: the bound matmuls must be exact in f32
    (TF32 would round their integer sums; a reduced-precision bf16
    reduction could round a bound down and drop a true candidate)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result, exact for integer sums below 2^24: bf16
    operands keep an f32 output on the card; f32 operands, and the CPU
    (whose matmul has no bf16 -> f32 form), multiply in f32."""
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))

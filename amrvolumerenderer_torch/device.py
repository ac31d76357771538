"""The explicit device every entry point of the port takes.

Entry points default to ``"cuda"`` and never fall back to the CPU: the CPU
runs only when a caller asks for it (``device="cpu"`` / ``--device cpu``),
and then every kernel runs its plain PyTorch version.  ``process_index``
is this process's rank in a several-process launch (0 in one process).
"""

from __future__ import annotations

from typing import Union

import torch
import torch.distributed as dist

DEFAULT_DEVICE = "cuda"

Device = Union[str, torch.device]


def resolve_device(device: Device = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available (torch.cuda.is_available() is false); pass "
                "device='cpu' (--device cpu) to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use cuda or cpu")
    return dev


def process_index() -> int:
    """This process's rank under ``torch.distributed``; 0 when no process
    group is up.  Only process 0 saves images (the JAX package's
    ``jax.process_index() == 0`` guard)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0

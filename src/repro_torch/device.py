"""Where the port's tensors live.

Every entry point of the port takes ``device=None``.  ``None`` means the
CUDA card: the port is written for it, and a run that silently fell back
to the CPU would measure PyTorch's CPU kernels under the card's name.
So ``None`` on a machine without CUDA raises; the CPU is used only when
the caller names it, as the tests do.
"""
from __future__ import annotations

import contextlib
from typing import ContextManager, Optional, Union

import torch

__all__ = ["resolve_device", "task_stream"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None means the CUDA card, and torch.cuda.is_available() "
                "is false here; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def task_stream(device: torch.device) -> ContextManager[Optional[torch.cuda.Stream]]:
    """A side stream for one task body on a CUDA device (no-op on the CPU).

    Concurrent pool workers that launch small, long-running kernels
    (a Mariani-Silver border strip is a few warps) would queue behind one
    another on the shared current stream; a stream per task lets them
    overlap on the card, the way concurrent serverless invocations
    overlap.  Only for task bodies whose tensors do not outlive the task
    on the device: the body must copy its results to the host before the
    scope ends.
    """
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device))

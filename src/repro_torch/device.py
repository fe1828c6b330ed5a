"""Device selection shared by the port's entry points.

Entry points (``Engine``, ``init_params``, ``pack_params`` and the kernel
wrappers' callers) run on ``cuda`` unless the caller names another
device. With no card and no explicit device they raise: the port never
carries on silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)

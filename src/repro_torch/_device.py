"""The port's device rule and host-to-device conversion.

Entry points run on CUDA unless the caller asks for another device; with
no request and no CUDA device they raise instead of falling back to the
CPU in silence.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA unless asked otherwise, and no "
                "CUDA device is visible; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def to_device(x: Any, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A tensor on ``device``.  Host arrays are always copied: a CPU tensor
    made with ``torch.from_numpy`` would alias the caller's buffer, and an
    index must not change when its caller later writes to that buffer."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)

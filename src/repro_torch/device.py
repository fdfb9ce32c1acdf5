"""Device policy shared by every public entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means the GPU.  A CUDA request on a machine without a CUDA
    device raises ``RuntimeError``: the port never carries on on the CPU
    unless the caller asked for it with ``device='cpu'``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} (use 'cuda' or 'cpu')")
    return dev


def as_tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.as_tensor`` that also accepts numpy arrays with any strides."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    import numpy as np

    arr = np.ascontiguousarray(x)
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)

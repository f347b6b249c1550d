"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Asking for ``cuda`` without one raises:
    nothing falls back to the CPU unless the caller passes ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def host_view(t: torch.Tensor):
    """Copy a tensor to a numpy array that keeps its bytes exact.

    numpy has no bfloat16, so a bf16 tensor comes back as the ``int16``
    view of its payload: the host paging code only moves, zero-fills and
    pads page bytes, which the integer view does bit-exactly (an all-zero
    int16 is bf16 +0.0)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def from_host(a, dtype: torch.dtype, device: Optional[torch.device] = None
              ) -> torch.Tensor:
    """Inverse of :func:`host_view`: numpy array -> tensor of ``dtype``."""
    t = torch.from_numpy(a)
    if dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    elif t.dtype != dtype:
        t = t.to(dtype)
    return t.to(device) if device is not None else t

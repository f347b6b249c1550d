"""Weight bridge: ``repro``'s ``init_params`` pytree, already converted to
numpy by the caller, becomes the port's parameter dict.  The layouts are
the same (``wq (d, h, hd)``, stacked ``blocks/l0/...``), so the bridge only
checks every leaf against the port's schema and moves it to the device.
Arrays of the ``ml_dtypes`` bfloat16 type are taken by their bytes, so the
port never needs that package."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as MD
from repro_torch.models.layers import ParamSpec, torch_dtype


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A copy of ``a`` (the caller's arrays may be read-only views)."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None) -> Dict[str, Any]:
    """Walk ``tree`` along the port's schema: every leaf must be there with
    the schema's shape and the config's dtype; extra leaves raise too."""
    device = resolve_device(device)
    def walk(node, spec, path):
        if isinstance(spec, ParamSpec):
            a = np.asarray(node)
            t = _tensor(a)
            want = torch_dtype(cfg.dtype)
            if tuple(t.shape) != spec.shape or t.dtype != want:
                raise ValueError(f"{path}: got {tuple(t.shape)} {t.dtype}, "
                                 f"schema wants {spec.shape} {want}")
            return t.to(device)
        if set(node) != set(spec):
            raise ValueError(f"{path}: keys {sorted(node)} != schema "
                             f"{sorted(spec)}")
        return {k: walk(node[k], spec[k], f"{path}/{k}") for k in spec}
    return walk(tree, MD.schema(cfg), "params")

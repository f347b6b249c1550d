"""Architecture registry of the port: ``get_config("llama3-8b")``,
``get_config("olmoe-1b-7b")`` and their ``-tiny`` variants.  The config
dataclasses are copies of ``repro.configs`` so the port depends on nothing
of the JAX package; the port serves the dense llama3-8b family and the
olmoe MoE family."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (INPUT_SHAPES, FreezeConfig, InputShape,
                                      ModelConfig)

_ARCH_MODULES = {
    "llama3-8b": "llama3_8b",
    "olmoe-1b-7b": "olmoe_1b_7b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    tiny = name.endswith("-tiny")
    base = name[: -len("-tiny")] if tiny else name
    if base not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[base]}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.tiny() if tiny else cfg


__all__ = [
    "ModelConfig",
    "FreezeConfig",
    "InputShape",
    "INPUT_SHAPES",
    "get_config",
    "list_archs",
]

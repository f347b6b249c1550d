"""Hand-written CUDA freeze-state update, Algorithm 1 lines 3-15 in one
elementwise pass (``csrc/relevance_freeze.cu``), and its ctypes binding
(``cuda_lib.CudaLibrary``: built with ``nvcc`` for ``sm_90a`` at first use,
never at import).  Unlike the Pallas kernel it takes per-lane (B,) clocks
and thresholds.  The wrapper allocates the new state with ``torch.empty``,
validates every input and raises on anything the kernel does not take;
``relevance_freeze_cuda.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.configs.base import FreezeConfig
from repro_torch.core.freeze import FreezeState
from repro_torch.kernels.cuda_lib import CudaLibrary, check_tensor, stream_ptr

LIB = CudaLibrary("relevance_freeze", "relevance_freeze_launch",
                  [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
build, load = LIB.build, LIB.load


def lane_vector(x, B: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A scalar or (B,) clock/threshold as a contiguous (B,) tensor."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    return t.reshape(-1).expand(B).contiguous() if t.dim() == 0 else t


def relevance_freeze_cuda(state: FreezeState, relevance: torch.Tensor, pos,
                          step, tau: torch.Tensor, cfg: FreezeConfig
                          ) -> Tuple[FreezeState, torch.Tensor]:
    """(new FreezeState, active (B, S) bool) — the same function as
    ``ref.relevance_freeze_ref``, on the card.  ``pos``/``step`` are
    scalars or (B,) int clocks, ``tau`` a (B,) f32 threshold."""
    B, S = relevance.shape
    dev = relevance.device
    if cfg.history < 1:
        raise ValueError(f"history must be >= 1, got {cfg.history}")
    pos = lane_vector(pos, B, torch.int32, dev)
    step = lane_vector(step, B, torch.int32, dev)
    tau = lane_vector(tau, B, torch.float32, dev)
    i32 = (torch.int32,)
    for name, t, shape, dts in (
            ("c", state.c, (B, S), i32), ("d", state.d, (B, S), i32),
            ("frozen", state.frozen, (B, S), (torch.bool,)),
            ("frozen_at", state.frozen_at, (B, S), i32),
            ("relevance", relevance, (B, S), (torch.float32,)),
            ("pos", pos, (B,), i32), ("step", step, (B,), i32),
            ("tau", tau, (B,), (torch.float32,))):
        check_tensor(t, name, shape, dts, dev)
    new = FreezeState(
        c=torch.empty((B, S), dtype=torch.int32, device=dev),
        d=torch.empty((B, S), dtype=torch.int32, device=dev),
        frozen=torch.empty((B, S), dtype=torch.bool, device=dev),
        frozen_at=torch.empty((B, S), dtype=torch.int32, device=dev))
    active = torch.empty((B, S), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        LIB.launch(state.c.data_ptr(), state.d.data_ptr(),
                   state.frozen.data_ptr(), state.frozen_at.data_ptr(),
                   relevance.data_ptr(), pos.data_ptr(), step.data_ptr(),
                   tau.data_ptr(), new.c.data_ptr(), new.d.data_ptr(),
                   new.frozen.data_ptr(), new.frozen_at.data_ptr(),
                   active.data_ptr(), B, S, cfg.window, float(cfg.k_soft),
                   cfg.history, stream_ptr(dev))
    relevance_freeze_cuda.launches += 1
    return new, active


relevance_freeze_cuda.launches = 0

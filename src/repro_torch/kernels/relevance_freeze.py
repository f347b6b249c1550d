"""Hand-written CUDA freeze-state update, Algorithm 1 lines 3-15 with the
per-lane quantile threshold found inside the kernel
(``csrc/relevance_freeze.cu``: one block per lane, a radix select of the
threshold, then the elementwise update), and its ctypes binding
(``cuda_lib.CudaLibrary``: built with ``nvcc`` for ``sm_90a`` at first use,
never at import).  One launch a call and no PyTorch op around it: the
threshold needs no sort.  It takes scalar or per-lane (B,) clocks; a given
(B,) ``tau`` skips the threshold (the Pallas kernel's function).  ``out``
may be the input state itself (an in-place update).  The wrapper validates
every input and raises on anything the kernel does not take;
``relevance_freeze_cuda.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import FreezeConfig
from repro_torch.core.freeze import FreezeState
from repro_torch.kernels.cuda_lib import CudaLibrary, check_tensor, stream_ptr

LIB = CudaLibrary("relevance_freeze", "relevance_freeze_launch",
                  [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                     ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
# an empty kernel on the same grid, built into the same library: the launch
# floor that chip_smoke.py times beside the kernel
FLOOR = CudaLibrary("relevance_freeze", "relevance_freeze_floor_launch",
                    [ctypes.c_int, ctypes.c_void_p])
build, load = LIB.build, LIB.load


def lane_vector(x, B: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A scalar or (B,) clock/threshold as a contiguous (B,) tensor; one
    that already is passes through untouched."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    return t.reshape(-1).expand(B).contiguous() if t.dim() == 0 else t


def _span(t: torch.Tensor):
    p = t.data_ptr()
    return p, p + t.numel() * t.element_size()


def _check_out(out: FreezeState, state: FreezeState,
               relevance: torch.Tensor) -> None:
    """Each output is its own input (in place) or overlaps no input and no
    other output: the kernel reads a slot's old values before it writes
    them, and nothing else."""
    ins = [(f, _span(t)) for f, t in zip(FreezeState._fields, state)]
    ins.append(("relevance", _span(relevance)))
    outs = [(f"out.{f}", _span(t)) for f, t in zip(FreezeState._fields, out)]
    for f, (o0, o1) in outs:
        for g, (t0, t1) in ins + outs:
            if g != f and o0 < t1 and t0 < o1 \
                    and not (f == f"out.{g}" and o0 == t0):
                raise ValueError(f"{f} overlaps {g}")


def relevance_freeze_cuda(state: FreezeState, relevance: torch.Tensor, pos,
                          step, cfg: FreezeConfig,
                          tau: Optional[torch.Tensor] = None,
                          out: Optional[FreezeState] = None,
                          active: bool = True,
                          active_count: Optional[torch.Tensor] = None,
                          tau_out: Optional[torch.Tensor] = None
                          ) -> Tuple[FreezeState, Optional[torch.Tensor]]:
    """(new FreezeState, active (B, S) bool or None) — the function of
    ``ref.relevance_freeze_ref``, on the card.  ``pos``/``step`` are
    scalars or (B,) int clocks.  ``tau=None`` takes the threshold from
    ``cfg`` inside the kernel; a (B,) f32 ``tau`` is used as given.
    ``out`` receives the new state (``out=state`` updates in place; None
    allocates it); ``active=False`` writes no mask; ``active_count``, a
    (B,) int32 tensor, gets each lane's active slot count added;
    ``tau_out``, a (B,) f32 tensor, receives the threshold used."""
    B, S = relevance.shape
    dev = relevance.device
    if B < 1 or S < 1:
        raise ValueError(f"relevance must be (B>=1, S>=1), got {(B, S)}")
    if cfg.history < 1:
        raise ValueError(f"history must be >= 1, got {cfg.history}")
    if cfg.tau_mode not in ("fixed", "quantile"):
        raise ValueError(f"unknown tau_mode {cfg.tau_mode!r}")
    pos = lane_vector(pos, B, torch.int32, dev)
    step = lane_vector(step, B, torch.int32, dev)
    i32 = (torch.int32,)
    checks = [("relevance", relevance, (B, S), (torch.float32,)),
              ("pos", pos, (B,), i32), ("step", step, (B,), i32)]
    dts = {"c": i32, "d": i32, "frozen": (torch.bool,), "frozen_at": i32}
    checks += [(f, t, (B, S), dts[f]) for f, t in zip(FreezeState._fields,
                                                      state)]
    if tau is not None:
        tau = lane_vector(tau, B, torch.float32, dev)
        checks.append(("tau", tau, (B,), (torch.float32,)))
    if active_count is not None:
        checks.append(("active_count", active_count, (B,), i32))
    if tau_out is not None:
        checks.append(("tau_out", tau_out, (B,), (torch.float32,)))
    if out is None:
        out = FreezeState(*(torch.empty((B, S), dtype=t.dtype, device=dev)
                            for t in state))
    else:
        checks += [(f"out.{f}", t, (B, S), dts[f])
                   for f, t in zip(FreezeState._fields, out)]
        _check_out(out, state, relevance)
    for name, t, shape, dtypes in checks:
        check_tensor(t, name, shape, dtypes, dev)
    act = torch.empty((B, S), dtype=torch.bool, device=dev) if active \
        else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        LIB.launch(*(t.data_ptr() for t in state), relevance.data_ptr(),
                   pos.data_ptr(), step.data_ptr(), ptr(tau),
                   *(t.data_ptr() for t in out), ptr(act),
                   ptr(active_count), ptr(tau_out), B, S, cfg.window,
                   float(cfg.k_soft), cfg.history,
                   int(cfg.tau_mode == "quantile"), float(cfg.quantile),
                   float(cfg.tau), stream_ptr(dev))
    relevance_freeze_cuda.launches += 1
    return out, act


relevance_freeze_cuda.launches = 0


def launch_floor(B: int, device) -> None:
    """Launch the empty kernel on ``relevance_freeze_cuda``'s grid for B
    lanes (timing only; not counted)."""
    with torch.cuda.device(device):
        FLOOR.launch(B, stream_ptr(device))

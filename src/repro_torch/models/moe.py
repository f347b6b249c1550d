"""Capacity-based top-k Mixture-of-Experts FFN (GShard/Switch style),
the PyTorch counterpart of ``repro.models.moe``.

The sequence is processed in groups of ``group_size`` tokens (a Python loop
here, ``lax.scan`` in the reference), each with its own per-expert
capacity, so the one-hot dispatch tensor (B, g, E, C) of one group is the
peak routing footprint.  Routing, capacity drops and the gate
renormalisation follow the reference step for step: the same one-hot
arithmetic in f32, the first maximal index on ties, and ``dispatch`` /
``combine`` cast to the activation dtype before the expert products.  The
reference's sharding annotations (``dag``) have no single-device
counterpart and are left out.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamSpec


def moe_schema(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamSpec((d, e)),
        "w_gate": ParamSpec((e, d, f)),
        "w_up": ParamSpec((e, d, f)),
        "w_down": ParamSpec((e, f, d)),
    }


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = tokens_per_group * cfg.experts_per_token * cfg.capacity_factor
    return max(1, int(-(-c // cfg.num_experts)))


def route(probs: torch.Tensor, cfg: ModelConfig, C: int):
    """Top-k routing with per-expert capacity.

    probs: (B, g, E) router softmax, f32.
    Returns (dispatch (B,g,E,C) f32 {0,1}, combine (B,g,E,C) f32,
             aux load-balance loss scalar)."""
    B, g, E = probs.shape
    K = cfg.experts_per_token
    f32 = torch.float32
    dev = probs.device
    combine = torch.zeros((B, g, E, C), dtype=f32, device=dev)
    dispatch = torch.zeros((B, g, E, C), dtype=f32, device=dev)
    remaining = probs
    prev_count = torch.zeros((B, 1, E), dtype=f32, device=dev)
    gates_sum = torch.zeros((B, g), dtype=f32, device=dev)
    first_onehot = None
    for _ in range(K):
        idx = torch.argmax(remaining, dim=-1)                   # (B,g)
        onehot = F.one_hot(idx, E).to(f32)                      # (B,g,E)
        if first_onehot is None:
            first_onehot = onehot
        gate = torch.sum(probs * onehot, dim=-1)                # (B,g)
        # position of each token within its expert's capacity buffer
        pos_in_expert = (torch.cumsum(onehot, dim=1) - onehot) + prev_count
        prev_count = prev_count + torch.sum(onehot, dim=1, keepdim=True)
        pos = torch.sum(pos_in_expert * onehot, dim=-1)         # (B,g)
        keep = pos < C                                          # capacity drop
        # jax.nn.one_hot gives a zero row past C; the keep mask zeroes it
        pos_oh = F.one_hot(pos.long().clamp(max=C - 1), C).to(f32)
        full = onehot[..., None] * pos_oh[..., None, :]         # (B,g,E,C)
        full = full * keep[..., None, None]
        dispatch = torch.maximum(dispatch, full)
        combine = combine + gate[..., None, None] * full
        gates_sum = gates_sum + gate * keep
        remaining = remaining * (1.0 - onehot)
    combine = combine / torch.clamp_min(gates_sum[..., None, None], 1e-9)
    # Switch aux loss: E * sum_e mean(probs_e) * mean(top1 == e)
    me = torch.mean(probs, dim=(0, 1))
    fe = torch.mean(first_onehot, dim=(0, 1))
    aux = E * torch.sum(me * fe)
    return dispatch, combine, aux


def _moe_group(p, xg: torch.Tensor, cfg: ModelConfig, C: int):
    """One token group. xg: (B, g, D) -> (y (B,g,D), aux)."""
    logits = xg.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine, aux = route(probs, cfg, C)
    dispatch = dispatch.to(xg.dtype)
    combine = combine.to(xg.dtype)
    xd = torch.einsum("bsec,bsd->ebcd", dispatch, xg)
    up = torch.einsum("ebcd,edf->ebcf", xd, p["w_up"])
    gate = torch.einsum("ebcd,edf->ebcf", xd, p["w_gate"])
    h = up * F.silu(gate)
    yd = torch.einsum("ebcf,efd->ebcd", h, p["w_down"])
    y = torch.einsum("bsec,ebcd->bsd", combine, yd)
    return y, aux


def moe_forward(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                    # (B, S, D)
    cfg: ModelConfig,
    group_size: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,D), aux_loss scalar)."""
    B, S, D = x.shape
    g = min(group_size, S)
    pad = (g - S % g) % g                # pad sequence to a group multiple
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    n_groups = xp.shape[1] // g
    C = capacity(g, cfg)
    if n_groups == 1:
        y, aux = _moe_group(p, xp, cfg, C)
        return y[:, :S], aux
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(n_groups):
        y, aux = _moe_group(p, xp[:, i * g:(i + 1) * g], cfg, C)
        aux_total = aux_total + aux
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], aux_total / n_groups

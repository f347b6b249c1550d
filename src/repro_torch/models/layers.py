"""Shared model building blocks (PyTorch counterpart of ``repro.models.
layers``).

Parameters are plain nested dicts of tensors in ``repro``'s layouts
(``wq (d, h, hd)``, ``wo (h, hd, d)``, ``w_up (d, f)``...).  Every module is
described once by a *schema* (``name -> ParamSpec``); :func:`init_from_schema`
walks it with ``repro``'s std rule.  The sharding helpers of the JAX package
(``constrain``, ``dag``) have no single-device counterpart and are left out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    scale: float = 1.0                # stddev multiplier over 1/sqrt(fan_in)


def stack_schema(schema: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Add a leading stacked-layer dim to every ParamSpec."""
    if isinstance(schema, ParamSpec):
        return ParamSpec((n,) + schema.shape, schema.scale)
    return {k: stack_schema(v, n) for k, v in schema.items()}


def init_from_schema(schema: Dict[str, Any], dtype: torch.dtype,
                     generator: torch.Generator,
                     device: torch.device) -> Dict[str, Any]:
    """Random parameters with ``repro``'s rule: ``N(0, 1) * scale /
    sqrt(fan_in)`` drawn in f32 then cast, zeros where ``scale == 0`` (the
    norms, stored as offset-from-1).  Drawn from ``generator`` on
    ``device``, one leading-dim slice at a time so a full-width stacked
    leaf never needs an f32 copy of itself."""
    out: Dict[str, Any] = {}
    for name in sorted(schema):
        spec = schema[name]
        if not isinstance(spec, ParamSpec):
            out[name] = init_from_schema(spec, dtype, generator, device)
            continue
        t = torch.zeros(spec.shape, dtype=dtype, device=device)
        if len(spec.shape) and spec.scale != 0.0:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale / math.sqrt(max(fan_in, 1))
            rows = t if len(spec.shape) > 2 else t[None]
            for r in rows:
                r.copy_(torch.randn(r.shape, generator=generator,
                                    device=device, dtype=torch.float32) * std)
        out[name] = t
    return out


# ===================================================================== #
# Norms
# ===================================================================== #
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


# ===================================================================== #
# RoPE (split-half rotation)
# ===================================================================== #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    angles = positions[..., None].float() * freqs              # (B, S, hd/2)
    if angles.dim() == 2:                                      # (S, hd/2)
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ===================================================================== #
# Prefill attention (plain PyTorch; the reference computes it outside any
# Pallas kernel too)
# ===================================================================== #
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset=0) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, KVH, hd) -> (B, Sq, H, hd).

    The reference's chunked online softmax, written as one block: scores in
    f32, masked entries at -1e30, ``exp(s - max)`` summed for the
    denominator and applied to V before the division, as the reference
    does per kv chunk.  ``q_offset`` is the global position of ``q[0]``."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, Sq, KVH, G, hd)
    s = torch.einsum("bqkgh,bckh->bkgqc", qf, k.float()) * scale
    mask = torch.ones((B, 1, 1, 1, Skv), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        kv_pos = torch.arange(Skv, device=q.device)
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])[None, None, None]
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    m = torch.clamp_min(s.amax(dim=-1), -1e30)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqc,bckh->bqkgh", p, v.float())
    l = l.permute(0, 3, 1, 2)[..., None]                        # (B,Sq,KVH,G,1)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, active_mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-step decode attention over a (frozen-masked) contiguous cache:
    q (B, H, hd), k/v (B, S, KVH, hd), active_mask (B, S) bool.

    Returns (out (B, H, hd) in q's dtype, relevance (B, S) f32), relevance
    being the paper's Eq. 2 score (1/H) sum_h |q_h . k_jh| on every slot.
    Scores are taken in f32; as in the reference the probabilities are
    cast to the cache dtype before P.V, and a row with nothing active
    gives zeros."""
    B, H, hd = q.shape
    _, S, KVH, _ = k_cache.shape
    G = H // KVH
    qf = q.reshape(B, KVH, G, hd).float()
    raw = torch.einsum("bkgh,bskh->bkgs", qf, k_cache.float())   # (B,KVH,G,S)
    relevance = torch.mean(torch.abs(raw), dim=(1, 2))
    s = raw / math.sqrt(hd)
    s = torch.where(active_mask[:, None, None, :], s,
                    torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    any_active = torch.any(active_mask, dim=-1)[:, None, None, None]
    p = torch.where(any_active, p, torch.zeros((), device=q.device))
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype), relevance


# ===================================================================== #
# GQA attention module
# ===================================================================== #
def attention_schema(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, h, hd)),
        "wk": ParamSpec((d, kvh, hd)),
        "wv": ParamSpec((d, kvh, hd)),
        "wo": ParamSpec((h, hd, d)),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, a, b) -> (..., a, b) as one matrix product."""
    d, a, b = w.shape
    return (x @ w.reshape(d, a * b)).reshape(*x.shape[:-1], a, b)


def attention_qkv(p, x, positions, theta):
    """x: (B,S,D) -> q (B,S,H,hd), k,v (B,S,KVH,hd) with RoPE applied."""
    q = apply_rope(_proj(x, p["wq"]), positions, theta)
    k = apply_rope(_proj(x, p["wk"]), positions, theta)
    return q, k, _proj(x, p["wv"])


def attention_out(p, o):
    """o: (B,S,H,hd) or (B,H,hd) -> (..., D)."""
    h, hd, d = p["wo"].shape
    return o.reshape(*o.shape[:-2], h * hd) @ p["wo"].reshape(h * hd, d)


# ===================================================================== #
# SwiGLU MLP
# ===================================================================== #
def mlp_schema(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_up": ParamSpec((d, f)), "w_down": ParamSpec((f, d)),
            "w_gate": ParamSpec((d, f))}


def mlp_forward(p, x):
    up = x @ p["w_up"]
    up = up * F.silu(x @ p["w_gate"])
    return up @ p["w_down"]

"""Sublinear freeze schedule (paper Eq. 3) and the adaptive threshold —
the parts of ``repro.core.freeze`` the paged decode step needs."""
from __future__ import annotations

import torch

from repro_torch.configs.base import FreezeConfig


def schedule(c: torch.Tensor, k_soft: float) -> torch.Tensor:
    """Eq. 3: d = floor(sqrt(c) / k) — sublinear freeze duration."""
    return torch.floor(torch.sqrt(c.float()) / k_soft).to(torch.int32)


def effective_tau(relevance: torch.Tensor, eligible: torch.Tensor,
                  cfg: FreezeConfig) -> torch.Tensor:
    """Paper mode: fixed tau.  "quantile" mode: per-sequence threshold at
    the ``cfg.quantile`` quantile of the eligible scores (linear
    interpolation, as ``jnp.nanquantile``); a row with no eligible score
    gets ``-inf`` so nothing is flagged."""
    if cfg.tau_mode == "fixed":
        return torch.tensor(cfg.tau, dtype=relevance.dtype,
                            device=relevance.device)
    scores = torch.where(eligible, relevance.float(),
                         torch.full((), float("nan"), device=relevance.device))
    tau = torch.nanquantile(scores, cfg.quantile, dim=-1, keepdim=True)
    tau = torch.where(torch.isnan(tau),
                      torch.full((), float("-inf"), device=tau.device), tau)
    return tau.to(relevance.dtype)

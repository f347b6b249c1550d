"""Contiguous KV cache and its host offload (PyTorch counterpart of
``repro.core.cache``).

The contiguous layout keeps (L, B, S_max, KVH, hd) buffers with a freeze
mask: every slot is addressable and frozen ones are excluded from
attention.  ``HostOffloadController`` keeps the paper's "frozen storage F"
in host RAM between steps: pages whose tokens are all frozen are copied to
the host store and their device slots zeroed (modelling release); a page
that thaws is copied back.

Where the reference round-trips the whole cache through the host on every
sync, this port moves only the pages whose state changes and updates the
device cache IN PLACE.  The cache, the store, ``offloaded``, the counters
and ``stash_bytes`` come out the same; ``moved_bytes`` counts the bytes
that really crossed (host copies of offloaded pages, uploads of restored
ones).

Under ``kv_quant`` "int8" or "fp8" each offloaded page is stored as its
1-byte payload with per-kv-head scales (``core.quant``); ``stash_bytes``
and the budget count the payload.  Quantization and the dequantization of
a restore run on the host, and a restored page is written back rounded to
the cache dtype, as the reference's host array does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.device import from_host, host_values, host_view


class KVCache(NamedTuple):
    k: torch.Tensor   # (L, B, S, KVH, hd)
    v: torch.Tensor   # (L, B, S, KVH, hd)

    @property
    def seq_len(self) -> int:
        return self.k.shape[2]


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    n_attn = sum(1 for l in range(cfg.num_layers) if cfg.is_attn_layer(l))
    shape = (n_attn, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def reset_lane(cache: KVCache, lane) -> KVCache:
    """Lane-granular reset: zero one batch lane's K/V slots (IN PLACE) so
    a retired request's cache cannot leak into the lane's next occupant."""
    cache.k[:, int(lane)] = 0
    cache.v[:, int(lane)] = 0
    return cache


def cache_write(k_layer: torch.Tensor, v_layer: torch.Tensor,
                new_k: torch.Tensor, new_v: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token (B, KVH, hd) at position ``pos`` into (B, S, KVH,
    hd), IN PLACE."""
    k_layer[:, int(pos)] = new_k.to(k_layer.dtype)
    v_layer[:, int(pos)] = new_v.to(v_layer.dtype)
    return k_layer, v_layer


@dataclasses.dataclass
class HostOffloadController:
    """Page-granular host residency of fully frozen KV (module docstring).

    Store keys are (layer, lane, page); values are host copies of the
    page's K and V (bf16 pages as int16 views of their bytes), or under a
    quant mode their 1-byte payloads, with the scales in ``quant_scales``.
    A page whose stored bytes would take the stash past
    ``stash_budget_bytes`` stays on the device (the freeze mask already
    excludes it from attention) and is counted in ``n_denied_offloads``;
    restores are never denied."""
    page_size: int
    store: Dict[Tuple[int, int, int], Tuple[np.ndarray, np.ndarray]] = \
        dataclasses.field(default_factory=dict)
    offloaded: set = dataclasses.field(default_factory=set)
    n_offloads: int = 0
    n_restores: int = 0
    stash_bytes: int = 0
    stash_budget_bytes: Optional[int] = None
    n_denied_offloads: int = 0
    kv_quant: str = "none"
    quant_scales: Dict[Tuple[int, int, int],
                       Tuple[np.ndarray, np.ndarray]] = \
        dataclasses.field(default_factory=dict)
    moved_bytes: int = 0       # host<->device bytes the syncs really moved

    def __post_init__(self):
        quant.resolve_mode(self.kv_quant)

    @property
    def stash_pressure(self) -> float:
        """Stash bytes as a fraction of the budget (0.0 when unbounded)."""
        if not self.stash_budget_bytes:
            return 0.0
        return self.stash_bytes / self.stash_budget_bytes

    def _all_frozen(self, frozen: np.ndarray,
                    reduced: bool = False) -> np.ndarray:
        """Page-granular reduction of the (L, B, S) token freeze mask, or a
        passthrough when the caller already reduced it to (L, B, n_pages)."""
        if reduced:
            return frozen
        L, B, S = frozen.shape
        pg = self.page_size
        n_pages = S // pg
        return frozen[:, :, : n_pages * pg].reshape(L, B, n_pages, pg) \
            .all(axis=-1)

    def needs_sync(self, frozen: np.ndarray, reduced: bool = False) -> bool:
        """True iff a ``sync`` with this mask would move any page: the
        fully-frozen set differs from the offloaded set."""
        all_frozen = self._all_frozen(frozen, reduced)
        want = {(int(l), int(b), int(p))
                for l, b, p in zip(*np.nonzero(all_frozen))}
        return want != self.offloaded

    def sync(self, cache: KVCache, frozen: np.ndarray,
             reduced: bool = False) -> KVCache:
        """frozen: (L, B, S) bool (post-step), or its (L, B, n_pages)
        page reduction when ``reduced``.  Offloads newly fully-frozen pages
        (host copy, device slots zeroed) and restores offloaded pages that
        thawed, IN PLACE on ``cache``; returns it."""
        pg = self.page_size
        all_frozen = self._all_frozen(frozen, reduced)
        mode = quant.MODES[self.kv_quant]
        for (l, b, p) in zip(*np.nonzero(all_frozen)):
            key = (int(l), int(b), int(p))
            if key in self.offloaded:
                continue
            sl = slice(key[2] * pg, (key[2] + 1) * pg)
            k_dev, v_dev = cache.k[key[0], key[1], sl], cache.v[key[0],
                                                                key[1], sl]
            nbytes = k_dev.nbytes + v_dev.nbytes
            if mode:
                # quantize first: the budget counts the 1-byte payload
                kk, ks = quant.quantize_page(
                    host_values(host_view(k_dev), cache.k.dtype), mode)
                vv, vs = quant.quantize_page(
                    host_values(host_view(v_dev), cache.v.dtype), mode)
                stored = kk.nbytes + vv.nbytes
            else:
                stored = nbytes
            if self.stash_budget_bytes is not None and \
                    self.stash_bytes + stored > self.stash_budget_bytes:
                self.n_denied_offloads += 1
                continue       # page stays resident (and frozen)
            if mode:
                self.quant_scales[key] = (ks, vs)
            else:
                # copies: on a CPU tensor host_view shares the tensor's
                # memory, which is zeroed below
                kk, vv = host_view(k_dev).copy(), host_view(v_dev).copy()
            self.moved_bytes += nbytes
            self.store[key] = (kk, vv)
            self.stash_bytes += stored
            self.offloaded.add(key)
            self.n_offloads += 1
            cache.k[key[0], key[1], sl] = 0             # model slot release
            cache.v[key[0], key[1], sl] = 0
        for key in sorted(self.offloaded):
            l, b, p = key
            if all_frozen[l, b, p]:
                continue
            kk, vv = self.store.pop(key)
            self.stash_bytes -= kk.nbytes + vv.nbytes
            qm = self.quant_scales.pop(key, None)
            if qm is not None:
                # f32 values, rounded to the cache dtype by from_host
                kk = quant.dequantize_page(kk, qm[0])
                vv = quant.dequantize_page(vv, qm[1])
            sl = slice(p * pg, (p + 1) * pg)
            k_new = from_host(kk, cache.k.dtype, cache.k.device)
            v_new = from_host(vv, cache.v.dtype, cache.v.device)
            cache.k[l, b, sl] = k_new
            cache.v[l, b, sl] = v_new
            self.moved_bytes += k_new.nbytes + v_new.nbytes
            self.offloaded.discard(key)
            self.n_restores += 1
        return cache

    @property
    def offloaded_tokens(self) -> int:
        return len(self.offloaded) * self.page_size

    def offloaded_tokens_lane(self, lane: int) -> int:
        """Offloaded token count of one batch lane."""
        return sum(self.page_size for key in self.offloaded if key[1] == lane)

    def drop_lane(self, lane: int) -> int:
        """Forget every offloaded page of one batch lane (the lane is being
        reassigned; its device slots are overwritten wholesale).  Returns
        the number of pages dropped."""
        stale = [key for key in self.offloaded if key[1] == lane]
        for key in stale:
            kv = self.store.pop(key, None)
            if kv is not None:
                self.stash_bytes -= kv[0].nbytes + kv[1].nbytes
            self.quant_scales.pop(key, None)
            self.offloaded.discard(key)
        return len(stale)

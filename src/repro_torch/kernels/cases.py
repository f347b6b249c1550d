"""The paged decode-attention kernel's contract cases, as numpy inputs made
from a seed.  The CPU tests feed them to the JAX reference, the Pallas
kernel (interpret mode) and the port's plain version; the chip smoke feeds
them to the CUDA kernel and its plain version.  The shapes are those of
``tests/test_kernels.py``'s paged sweeps, plus the serving shape of the
main path, plus layouts aimed at the CUDA kernel's split of the page walk
(``paged_decode_attn.pages_per_block``): a P the pages-per-block does not
divide, a split whose pages are all skipped, and a lane whose only live
page is the last.

Each ``Case`` carries float32 arrays; ``dtype`` says which type the
floats (q, K, V) are cast to before the call.  Quantized cases hold the
1-byte payload *values* in their pool, as the controller stores them, and
``full`` holds the unquantized inputs for the lossy-envelope check.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.kernels.paged_decode_attn import (PAGE_SPLITS,
                                                  pages_per_block)

TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# lossy envelope of quantized attention vs the full-precision inputs
QUANT_TOLS = {"int8": dict(rtol=5e-2, atol=5e-2),
              "fp8": dict(rtol=2e-1, atol=1e-1)}
DTYPES = ("float32", "bfloat16")
FLOAT_INPUTS = ("q", "k_pages", "v_pages")
ARG_ORDER = ("q", "k_pages", "v_pages", "slot_mask", "page_table",
             "page_visible", "page_quant", "kv_scales")

SWEEP_SHAPES = [(1, 4, 128, 8, 8, 64), (2, 8, 64, 8, 2, 64),
                (2, 6, 128, 4, 1, 128), (3, 5, 32, 16, 8, 128)]
UNMAPPED_SHAPES = [(1, 4, 128, 8, 8, 64), (2, 6, 64, 8, 2, 64)]
VISIBLE_SHAPES = [(1, 4, 128, 8, 8, 64), (2, 6, 64, 8, 2, 64),
                  (3, 5, 32, 16, 8, 128)]
# B, P, page, H, KVH, hd of one decode step of llama3-8b in the engine
MAIN_PATH_SHAPE = (4, 8, 64, 32, 8, 128)
# the same for olmoe-1b-7b: 16 query heads on 16 kv heads (G = 1)
MOE_MAIN_PATH_SHAPE = (4, 8, 64, 16, 16, 128)
# P = 2 * PAGE_SPLITS + 1: three pages a block of the CUDA walk, the last
# split two pages long
SPLIT_SHAPE = (2, 2 * PAGE_SPLITS + 1, 16, 8, 2, 64)


@dataclasses.dataclass
class Case:
    name: str
    dtype: str
    inputs: Dict[str, np.ndarray]
    zero_rel_pages: Tuple[int, ...] = ()     # relevance exactly 0 there
    mode: Optional[str] = None               # quant mode of the pool
    full: Optional[Dict[str, np.ndarray]] = None

    @property
    def tols(self) -> dict:
        return TOLS[self.dtype]


def _randn(rng, *shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(rng, B, P, page, H, KVH, hd):
    return {"q": _randn(rng, B, H, hd),
            "k_pages": _randn(rng, B, P, page, KVH, hd),
            "v_pages": _randn(rng, B, P, page, KVH, hd)}


def _arange_table(B, P) -> np.ndarray:
    return np.tile(np.arange(P, dtype=np.int32), (B, 1))


def round_to(x: np.ndarray, dtype: str) -> np.ndarray:
    """Round float32 values through ``dtype`` and back (identity for f32)."""
    if dtype == "float32":
        return x
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def quantize_pool(pool: np.ndarray, flags: np.ndarray, mode: str):
    """Quantize the flagged pages of a (B, P, page, KVH, hd) f32 pool the
    way the controller stores them: payload values in the pool, per-page
    per-kv-head scales ((B, P, KVH) f32, 1.0 where unflagged)."""
    m = quant.MODES[mode]
    B, P, _, KVH, _ = pool.shape
    scales = np.ones((B, P, KVH), np.float32)
    out = pool.copy()
    for b in range(B):
        for p in range(P):
            if flags[b, p]:
                payload, sc = quant.quantize_page(pool[b, p], m)
                out[b, p] = quant.payload_values(payload)
                scales[b, p] = sc
    return out, scales


def sweep_case(shape, dtype) -> Case:
    B, P, page, H, KVH, hd = shape
    rng = np.random.RandomState(2)
    x = _qkv(rng, *shape)
    sm = rng.rand(B, P, page) < 0.5
    sm[:, 0, 0] = True
    sm[:, -1] = False                        # one dead (fully frozen) page
    return Case(f"sweep-{'x'.join(map(str, shape))}-{dtype}", dtype,
                dict(x, slot_mask=sm), zero_rel_pages=(P - 1,))


def unmapped_case(shape) -> Case:
    """Stale mask bits on an unmapped slot: the page table wins."""
    B, P, page, H, KVH, hd = shape
    rng = np.random.RandomState(5)
    pt = np.zeros((B, P), np.int32)
    pt[:, 1] = -1
    return Case(f"unmapped-{'x'.join(map(str, shape))}", "float32",
                dict(_qkv(rng, *shape), slot_mask=np.ones((B, P, page), bool),
                     page_table=pt), zero_rel_pages=(1,))


def visible_case(shape, dtype) -> Case:
    B, P, page, H, KVH, hd = shape
    rng = np.random.RandomState(6)
    x = _qkv(rng, *shape)
    vis = rng.rand(B, P) < 0.5
    vis[:, 0] = True
    return Case(f"visible-{'x'.join(map(str, shape))}-{dtype}", dtype,
                dict(x, slot_mask=np.ones((B, P, page), bool),
                     page_table=_arange_table(B, P), page_visible=vis))


def quant_case(shape, dtype, mode) -> Case:
    """Mixed pool per lane: hot, frozen-invisible (slot 1) and quantized
    (odd slots) pages coexisting."""
    B, P, page, H, KVH, hd = shape
    rng = np.random.RandomState(7)
    x = _qkv(rng, *shape)
    x = {k: round_to(a, dtype) for k, a in x.items()}
    sm = rng.rand(B, P, page) < 0.7
    sm[:, 0, 0] = True
    vis = np.ones((B, P), bool)
    vis[:, 1] = False
    flags = np.zeros((B, P), bool)
    flags[:, 1::2] = True
    kq, ksc = quantize_pool(x["k_pages"], flags, mode)
    vq, vsc = quantize_pool(x["v_pages"], flags, mode)
    base = dict(slot_mask=sm, page_table=_arange_table(B, P),
                page_visible=vis)
    return Case(f"quant-{mode}-{'x'.join(map(str, shape))}-{dtype}", dtype,
                dict(base, q=x["q"], k_pages=kq, v_pages=vq,
                     page_quant=flags.astype(np.int32),
                     kv_scales=np.stack([ksc, vsc], axis=2)),
                zero_rel_pages=(1,), mode=mode, full=dict(base, **x))


def main_path_case(shape=MAIN_PATH_SHAPE) -> Case:
    """The serving shape: bf16, some pages unmapped, some frozen, a
    partly written tail page."""
    B, P, page, H, KVH, hd = shape
    rng = np.random.RandomState(11)
    x = _qkv(rng, *shape)
    pt = _arange_table(B, P)
    pt[:, -1] = -1                           # the free tail-reserve slot
    vis = rng.rand(B, P) < 0.8
    sm = np.ones((B, P, page), bool)
    sm[:, P - 2, page // 2:] = False         # partly written tail page
    return Case("main-path-" + "x".join(map(str, shape))
                + "-bfloat16", "bfloat16",
                dict(x, slot_mask=sm, page_table=pt, page_visible=vis),
                zero_rel_pages=(P - 1,))


def _split_layout(seed):
    B, P, page, H, KVH, hd = SPLIT_SHAPE
    rng = np.random.RandomState(seed)
    x = _qkv(rng, *SPLIT_SHAPE)
    sm = rng.rand(B, P, page) < 0.6
    sm[:, :, 0] = True
    return rng, x, sm, _arange_table(B, P), np.ones((B, P), bool)


def ragged_split_case(dtype) -> Case:
    """A P that pages-per-block does not divide: the last split of the
    walk is shorter than the others."""
    _, x, sm, pt, vis = _split_layout(21)
    return Case(f"ragged-split-{'x'.join(map(str, SPLIT_SHAPE))}-{dtype}",
                dtype, dict(x, slot_mask=sm, page_table=pt,
                            page_visible=vis))


def dead_split_case(dtype) -> Case:
    """Every page of the second split is skipped, one of each kind:
    unmapped (with set mask bits), invisible, and empty-masked."""
    _, x, sm, pt, vis = _split_layout(22)
    ppb = pages_per_block(SPLIT_SHAPE[1])
    p0 = ppb                                   # the second split's pages
    pt[:, p0] = -1
    vis[:, p0 + 1] = False
    sm[:, p0 + 2] = False
    return Case(f"dead-split-{'x'.join(map(str, SPLIT_SHAPE))}-{dtype}",
                dtype, dict(x, slot_mask=sm, page_table=pt,
                            page_visible=vis),
                zero_rel_pages=tuple(range(p0, p0 + ppb)))


def last_page_only_case(dtype) -> Case:
    """Lane 0's only live page is the last one (the others unmapped,
    invisible or empty); lane 1 is ordinary."""
    _, x, sm, pt, vis = _split_layout(23)
    P = SPLIT_SHAPE[1]
    pt[0, :P - 1:3] = -1
    vis[0, 1:P - 1:3] = False
    sm[0, 2:P - 1:3] = False
    return Case(f"last-page-only-{'x'.join(map(str, SPLIT_SHAPE))}-{dtype}",
                dtype, dict(x, slot_mask=sm, page_table=pt,
                            page_visible=vis))


def tolerance_cases() -> List[Case]:
    """Every case whose kernel output is held against the plain version
    within ``TOLS``."""
    cases = [sweep_case(s, d) for s in SWEEP_SHAPES for d in DTYPES]
    cases += [unmapped_case(s) for s in UNMAPPED_SHAPES]
    cases += [visible_case(s, d) for s in VISIBLE_SHAPES for d in DTYPES]
    cases += [quant_case(s, d, m) for s in SWEEP_SHAPES for d in DTYPES
              for m in ("int8", "fp8")]
    cases += [f(d) for f in (ragged_split_case, dead_split_case,
                              last_page_only_case) for d in DTYPES]
    cases.append(main_path_case())
    return cases


# --------------------------------------------------------------------- #
# Contract pairs: two input sets whose results must be bit-identical
# --------------------------------------------------------------------- #
def _contract_base(seed, B=2, P=6, page=64, H=8, KVH=2, hd=64):
    rng = np.random.RandomState(seed)
    return rng, _qkv(rng, B, P, page, H, KVH, hd), (B, P, page, KVH)


def none_identity_pair():
    """All-zero quant flags and all-one scales vs no quant operands."""
    rng, x, (B, P, page, KVH) = _contract_base(8)
    sm = rng.rand(B, P, page) < 0.5
    sm[:, 0, 0] = True
    plain = dict(x, slot_mask=sm, page_table=_arange_table(B, P))
    flagged = dict(plain, page_quant=np.zeros((B, P), np.int32),
                   kv_scales=np.ones((B, P, 2, KVH), np.float32))
    return flagged, plain, ()


def poisoned_scales_pair():
    """Quantized pages that are unmapped (slot 1) or invisible (slot 2)
    carry 1e9 scales; they must be skipped before the scale is read."""
    rng, x, (B, P, page, KVH) = _contract_base(9)
    pt = _arange_table(B, P)
    pt[:, 1] = -1
    vis = np.ones((B, P), bool)
    vis[:, 2] = False
    plain = dict(x, slot_mask=np.ones((B, P, page), bool), page_table=pt,
                 page_visible=vis)
    pq = np.zeros((B, P), np.int32)
    pq[:, 1:3] = 1
    sc = np.ones((B, P, 2, KVH), np.float32)
    sc[:, 1:3] = 1e9
    return dict(plain, page_quant=pq, kv_scales=sc), plain, (1, 2)


def staging_slot_pair():
    """Live garbage K/V (and set mask bits) in an unmapped staging slot vs
    the same slot zeroed."""
    rng = np.random.RandomState(0)
    B, P, page, H, KVH, hd = 2, 4, 8, 4, 2, 16
    x = _qkv(rng, B, P, page, H, KVH, hd)
    pt = _arange_table(B, P)
    pt[:, -1] = -1
    sm = np.ones((B, P, page), bool)
    garbage = dict(x, slot_mask=sm, page_table=pt)
    zeroed = dict(garbage, k_pages=x["k_pages"].copy(),
                  v_pages=x["v_pages"].copy())
    zeroed["k_pages"][:, -1] = 0
    zeroed["v_pages"][:, -1] = 0
    return garbage, zeroed, (P - 1,)


# speculative staging slots a lane of the async paged engine (the default
# ``ServingConfig.speculative_slots``)
STAGING_SLOTS = 3


def staged_layout_pair(dtype: str = "bfloat16", S: int = STAGING_SLOTS,
                       shape=MAIN_PATH_SHAPE):
    """The main-path case at its pool of P pages, and the same pages at the
    async engine's layout of P + S: the S staging slots after them hold
    live K/V with every mask bit set but are unmapped, as the engine leaves
    them.  Called with ``reserved_slots=S``, the kernel must give the P
    pool's output and relevance bit for bit (relevance 0 on the staging
    slots).  Returns (P case, P + S case, S)."""
    base = main_path_case(shape)
    B, P, page, H, KVH, hd = shape
    rng = np.random.RandomState(13)
    extra = _qkv(rng, B, S, page, H, KVH, hd)
    x = dict(base.inputs)
    for k in ("k_pages", "v_pages"):
        x[k] = np.concatenate([x[k], extra[k]], axis=1)
    x["slot_mask"] = np.concatenate(
        [x["slot_mask"], np.ones((B, S, page), bool)], axis=1)
    x["page_table"] = np.concatenate(
        [x["page_table"], np.full((B, S), -1, np.int32)], axis=1)
    x["page_visible"] = np.concatenate(
        [x["page_visible"], np.ones((B, S), bool)], axis=1)
    staged_shape = (B, P + S, page, H, KVH, hd)
    plain = dataclasses.replace(base, dtype=dtype)
    staged = Case("main-path-staged-" + "x".join(map(str, staged_shape))
                  + "-" + dtype, dtype, x,
                  zero_rel_pages=base.zero_rel_pages
                  + tuple(range(P, P + S)))
    return plain, staged, S


def quantized_layout_pair(mode: str, dtype: str = "bfloat16",
                          shape=MAIN_PATH_SHAPE):
    """The async main path's P + S layout with every other live page
    quantized in ``mode`` (13 of its 25 live pages at llama3-8b's shape),
    as the engine leaves a pool: payload values in the pool, the mode in
    ``page_quant``, per-page per-kv-head scales.  ``full`` holds the same
    pages unquantized (rounded to ``dtype`` first) for the lossy-envelope
    check.  Returns (quantized case, the same pages with no flag set and
    unit scales, S)."""
    _, staged, S = staged_layout_pair(dtype, shape=shape)
    x = {k: round_to(a, dtype) if k in FLOAT_INPUTS else a
         for k, a in staged.inputs.items()}
    pt, vis, sm = x["page_table"], x["page_visible"], x["slot_mask"]
    live = (pt >= 0) & vis & sm.any(-1)
    flags = np.zeros(live.shape, bool)
    flags[tuple(np.argwhere(live)[::2].T)] = True
    kq, ksc = quantize_pool(x["k_pages"], flags, mode)
    vq, vsc = quantize_pool(x["v_pages"], flags, mode)
    B, P = pt.shape
    KVH = x["k_pages"].shape[3]
    shape = "x".join(map(str, x["k_pages"].shape[:2]))
    if KVH != MAIN_PATH_SHAPE[4]:
        shape += f"-kvh{KVH}"
    quantized = Case(f"main-path-staged-{mode}-{shape}-{dtype}", dtype,
                     dict(x, k_pages=kq, v_pages=vq,
                          page_quant=flags.astype(np.int32)
                          * quant.MODES[mode],
                          kv_scales=np.stack([ksc, vsc], axis=2)),
                     zero_rel_pages=staged.zero_rel_pages, mode=mode,
                     full=x)
    unflagged = Case(f"main-path-staged-unflagged-{shape}-{dtype}", dtype,
                     dict(x, page_quant=np.zeros((B, P), np.int32),
                          kv_scales=np.ones((B, P, 2, KVH), np.float32)),
                     zero_rel_pages=staged.zero_rel_pages)
    return quantized, unflagged, S


MOE_KINDS = DTYPES + ("int8", "fp8")


def moe_case(kind: str) -> Tuple[Case, int]:
    """Kernel 1 at olmoe-1b-7b's decode shape (H = KVH = 16, G = 1): the
    async main path's P + S layout at f32 or bf16 (``kind`` a dtype), or
    with every other live page quantized in ``kind`` (int8, fp8; bf16).
    Returns (case, S): the kernel is called with ``reserved_slots=S`` as
    the engine calls it."""
    if kind in DTYPES:
        _, case, S = staged_layout_pair(kind, shape=MOE_MAIN_PATH_SHAPE)
    else:
        case, _, S = quantized_layout_pair(kind, shape=MOE_MAIN_PATH_SHAPE)
    return case, S


def dead_lane_inputs():
    """Lane 0 has no live page (unmapped, invisible or empty-masked);
    lane 1 is live.  Lane 0 must output zeros and relevance 0."""
    rng = np.random.RandomState(12)
    B, P, page, H, KVH, hd = 2, 5, 32, 8, 2, 64
    x = _qkv(rng, B, P, page, H, KVH, hd)
    pt = _arange_table(B, P)
    vis = np.ones((B, P), bool)
    sm = np.ones((B, P, page), bool)
    pt[0, :2] = -1
    vis[0, 2:4] = False
    sm[0, 4] = False
    return dict(x, slot_mask=sm, page_table=pt, page_visible=vis)


def to_torch(inputs: Dict[str, np.ndarray], dtype: str,
             device) -> Dict[str, torch.Tensor]:
    """numpy inputs -> tensors on ``device``, floats cast to ``dtype``."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    out = {}
    for k, a in inputs.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        out[k] = (t.to(tdt) if k in FLOAT_INPUTS else t).to(device)
    return out


def call_args(tensors: Dict[str, torch.Tensor]):
    """Positional arguments in the kernel's order (absent tables None)."""
    return [tensors.get(k) for k in ARG_ORDER]

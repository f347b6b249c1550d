"""Contract cases of the contiguous path's two kernels, as numpy inputs made
from a seed: freeze-masked decode attention (``freeze_decode_attn``) and
the fused freeze update (``relevance_freeze``).  The CPU tests feed them to
the JAX reference and the Pallas kernels (interpret mode) and to the
port's plain versions; the chip smoke and the card tests feed them to the
CUDA kernels and their plain versions.

Attention shapes are those of ``tests/test_kernels.py``'s freeze-masked
sweep, plus a ragged S no chunk divides, a many-block shape, a
skipped-block case, a dead lane and the main path's shape, and two
layouts aimed at the CUDA kernel's chunks (``freeze_decode_attn.CHUNK``):
a ragged last chunk alone in its block, and a chunk whose one active slot
is its last.  Freeze-update cases are that file's
sweep, crossed with scalar and per-lane clocks and fixed and quantile
thresholds, plus the main path's shape, plus cases aimed at the threshold
the fused kernel finds itself (``threshold_cases``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.freeze import FreezeState
from repro_torch.kernels.cases import DTYPES, TOLS, round_to
from repro_torch.kernels.freeze_decode_attn import CHUNK

# B, S, H, KVH, hd of tests/test_kernels.py:50-55
ATTN_SWEEP = [(1, 512, 8, 8, 64), (2, 1024, 8, 4, 64), (2, 512, 4, 1, 128),
              (3, 768, 16, 8, 128)]
# one layer of llama3-8b in ContinuousEngine's decode step (4 lanes,
# max_seq 2048), and the Table-1 protocol's cache (max_seq 560, 1 lane)
MAIN_PATH_SHAPE = (4, 2048, 32, 8, 128)
# the same for olmoe-1b-7b: 16 query heads on 16 kv heads (G = 1)
MOE_MAIN_PATH_SHAPE = (4, 2048, 16, 16, 128)
TABLE1_SHAPE = (1, 560, 32, 8, 128)
SPLIT_SHAPE = (8, 1200, 16, 8, 64)
# the slot layout of the cases above was written for chunks of 128 slots;
# it stays put whatever the kernel's CHUNK
BLOCK = 128


@dataclasses.dataclass
class AttnCase:
    name: str
    dtype: str
    inputs: Dict[str, np.ndarray]     # q, k, v float32; active_mask bool

    @property
    def tols(self) -> dict:
        return TOLS[self.dtype]


def _qkv(rng, B, S, H, KVH, hd, dtype):
    r = lambda *s: round_to(rng.standard_normal(s).astype(np.float32), dtype)
    return {"q": r(B, H, hd), "k": r(B, S, KVH, hd), "v": r(B, S, KVH, hd)}


def _main_path_mask(rng, B, S):
    """Per-lane written prefixes of different lengths, about half of each
    written prefix frozen, and whole kernel chunks with no active slot."""
    lens = np.array([S, S - 300, S // 2 + 17, 700])[:B]
    mask = np.zeros((B, S), bool)
    for b, n in enumerate(lens):
        mask[b, :n] = rng.rand(n) < 0.5
        mask[b, n - 16:n] = True                  # the window stays active
    mask[:, 3 * BLOCK:5 * BLOCK] = False          # fully inactive chunks
    return mask


def attn_cases() -> List[AttnCase]:
    out = []
    for shape in ATTN_SWEEP:
        B, S, H, KVH, hd = shape
        for dtype in DTYPES:
            rng = np.random.RandomState(sum(shape))
            x = _qkv(rng, B, S, H, KVH, hd, dtype)
            mask = rng.rand(B, S) < 0.5
            mask[:, 0] = True
            out.append(AttnCase(f"sweep-{B}x{S}x{H}x{KVH}x{hd}-{dtype}",
                                dtype, dict(x, active_mask=mask)))
    for name, (B, S, H, KVH, hd) in (("ragged", TABLE1_SHAPE),
                                     ("ragged2", (2, 560, 8, 2, 64))):
        for dtype in DTYPES:
            rng = np.random.RandomState(S + B)
            x = _qkv(rng, B, S, H, KVH, hd, dtype)
            mask = rng.rand(B, S) < 0.6
            mask[:, S - 20:] = True               # the ragged last chunk
            out.append(AttnCase(f"{name}-{B}x{S}-{dtype}", dtype,
                                dict(x, active_mask=mask)))
    # many (lane, kv head) pairs and chunks
    B, S, H, KVH, hd = SPLIT_SHAPE
    for dtype in DTYPES:
        rng = np.random.RandomState(S + H)
        x = _qkv(rng, B, S, H, KVH, hd, dtype)
        mask = rng.rand(B, S) < 0.5
        mask[:, 2 * BLOCK:3 * BLOCK] = False      # a whole chunk
        out.append(AttnCase(f"split-{B}x{S}-{dtype}", dtype,
                            dict(x, active_mask=mask)))
    for dtype in DTYPES:
        # the last chunk holds 5 slots, alone in its block
        B, S, H, KVH, hd = 2, 2 * CHUNK + 5, 8, 2, 64
        rng = np.random.RandomState(S)
        x = _qkv(rng, B, S, H, KVH, hd, dtype)
        mask = rng.rand(B, S) < 0.5
        mask[:, S - 5:] = True
        out.append(AttnCase(f"ragged-last-chunk-{B}x{S}-{dtype}", dtype,
                            dict(x, active_mask=mask)))
        # the second chunk's only active slot is its last
        B, S = 2, 3 * CHUNK
        rng = np.random.RandomState(S + 1)
        x = _qkv(rng, B, S, H, KVH, hd, dtype)
        mask = rng.rand(B, S) < 0.5
        mask[:, CHUNK:2 * CHUNK] = False
        mask[:, 2 * CHUNK - 1] = True
        out.append(AttnCase(f"one-slot-chunk-{B}x{S}-{dtype}", dtype,
                            dict(x, active_mask=mask)))
    out.append(main_path_case())
    return out


def main_path_case(shape=MAIN_PATH_SHAPE,
                   dtype: str = "bfloat16") -> AttnCase:
    B, S, H, KVH, hd = shape
    rng = np.random.RandomState(7)
    x = _qkv(rng, B, S, H, KVH, hd, dtype)
    heads = "" if shape == MAIN_PATH_SHAPE else f"x{H}x{KVH}"
    return AttnCase(f"main-path-{B}x{S}{heads}-{dtype}", dtype,
                    dict(x, active_mask=_main_path_mask(rng, B, S)))


def skipped_block_inputs() -> Dict[str, np.ndarray]:
    """tests/test_kernels.py:75-89: a fully inactive block must not
    contribute and reports relevance 0 (f32, G = 1)."""
    rng = np.random.RandomState(1)
    x = _qkv(rng, 1, 512, 4, 4, 64, "float32")
    mask = np.ones((1, 512), bool)
    mask[:, 128:256] = False
    return dict(x, active_mask=mask)


def dead_lane_inputs() -> Dict[str, np.ndarray]:
    """Lane 0 has no active slot (its K/V are huge, as frozen garbage may
    be): it must output zeros and relevance 0; lane 1 is ordinary."""
    rng = np.random.RandomState(2)
    x = _qkv(rng, 2, 300, 8, 2, 64, "float32")
    x["k"][0] *= 1e6
    x["v"][0] *= 1e6
    mask = rng.rand(2, 300) < 0.5
    mask[0] = False
    return dict(x, active_mask=mask)


def attn_args(inputs: Dict[str, np.ndarray], dtype: str, device):
    """(q, k, v, active_mask) tensors on ``device``; floats in ``dtype``."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    f = lambda n: torch.from_numpy(inputs[n]).to(device=device, dtype=dt)
    return (f("q"), f("k"), f("v"),
            torch.from_numpy(inputs["active_mask"]).to(device))


# ------------------------------------------------------------------ #
# Fused freeze update
# ------------------------------------------------------------------ #
# tests/test_kernels.py:304-305: (B, S) and (window, k_soft, history)
FREEZE_SHAPES = [(1, 256), (2, 1024), (4, 512)]
FREEZE_PARAMS = [(8, 2.0, 10**6), (4, 1.0, 64)]


@dataclasses.dataclass
class FreezeCase:
    name: str
    cfg: Dict[str, object]            # FreezeConfig fields
    inputs: Dict[str, np.ndarray]     # c, d, frozen, frozen_at, relevance
    pos: np.ndarray                   # () or (B,) int32
    step: np.ndarray


def _freeze_inputs(rng, B, S):
    return {"c": rng.randint(0, 20, (B, S)).astype(np.int32),
            "d": rng.randint(0, 5, (B, S)).astype(np.int32),
            "frozen": rng.rand(B, S) < 0.3,
            "frozen_at": rng.randint(-1, 50, (B, S)).astype(np.int32),
            "relevance": rng.rand(B, S).astype(np.float32)}


def freeze_cases() -> List[FreezeCase]:
    out = []
    for B, S in FREEZE_SHAPES:
        for window, k_soft, history in FREEZE_PARAMS:
            for clocks in ("scalar", "per_lane"):
                for tau_mode in ("fixed", "quantile"):
                    rng = np.random.RandomState(B * S + window)
                    if clocks == "scalar":
                        pos = np.int32(S - 5)
                        step = np.int32(history - 1)
                    else:
                        pos = rng.randint(0, S, B).astype(np.int32)
                        step = rng.randint(0, 3 * history, B) \
                            .astype(np.int32) if history < 10**5 else \
                            rng.randint(0, 1000, B).astype(np.int32)
                    cfg = dict(window=window, tau=0.5, k_soft=k_soft,
                               history=history, tau_mode=tau_mode,
                               quantile=0.45)
                    out.append(FreezeCase(
                        f"{B}x{S}-w{window}-k{k_soft}-h{history}-{clocks}-"
                        f"{tau_mode}", cfg, _freeze_inputs(rng, B, S),
                        pos, step))
    # the main path: one layer's state in ContinuousEngine's decode step
    B, S = MAIN_PATH_SHAPE[:2]
    rng = np.random.RandomState(11)
    out.append(FreezeCase(
        "main-path-4x2048", dict(window=16, k_soft=1.0, history=256,
                                 tau_mode="quantile", quantile=0.45),
        _freeze_inputs(rng, B, S),
        np.array([2047, 1500, 1041, 699], np.int32),
        np.array([255, 100, 17, 3], np.int32)))
    return out + threshold_cases()


def _quantile_cfg(**kw):
    return dict(dict(window=8, k_soft=1.0, history=64, tau_mode="quantile",
                     quantile=0.45), **kw)


def threshold_cases() -> List[FreezeCase]:
    """Cases aimed at the threshold the fused kernel selects itself (its
    radix select, its f32 rank arithmetic, its shared-memory key budget of
    4096 slots) — all in quantile mode."""
    out = []

    def add(name, B, S, pos, step, seed, cfg=None, edit=None):
        rng = np.random.RandomState(seed)
        x = _freeze_inputs(rng, B, S)
        if edit is not None:
            edit(rng, x)
        out.append(FreezeCase(name, cfg or _quantile_cfg(), x,
                              np.asarray(pos, np.int32),
                              np.asarray(step, np.int32)))

    def ties(rng, x):
        # five values: the ranks low and high fall inside runs of equal keys
        x["relevance"] = (rng.randint(0, 5, x["relevance"].shape) / 4) \
            .astype(np.float32)

    add("ties-4x512-per_lane", 4, 512, [511, 400, 77, 300], [5, 63, 0, 17],
        21, edit=ties)
    add("ties-2x512-scalar", 2, 512, 500, 63, 22, edit=ties,
        cfg=_quantile_cfg(quantile=0.6))

    def nan(rng, x):
        r, fr = x["relevance"], x["frozen"]
        elig = lambda b: np.nonzero(~fr[b, :290])[0]   # pos 297, window 8
        r[0, elig(0)[5]] = np.nan                 # one eligible NaN
        r[1, elig(1)] = np.nan                    # every eligible score NaN
        r[2, fr[2]] = np.nan                      # NaN only where frozen,
        r[2, 295:] = np.nan                       # in the window, unwritten
        r[3, elig(3)[:3]] = [np.inf, -np.inf, np.inf]
        r[3, elig(3)[3]] = -0.0
    add("nan-4x300", 4, 300, 297, 11, 23, edit=nan)

    def few(rng, x):
        # lane 0: every slot outside the window frozen (0 eligible); lane
        # 1: exactly one eligible slot; lanes 2 and 3: exactly two, lane
        # 3's -inf and +inf (their blend is NaN, so tau is -inf)
        fr = x["frozen"]
        fr[:, :120] = True
        fr[1, 40] = False
        fr[2:, [3, 99]] = False
        x["relevance"][3, [3, 99]] = [-np.inf, np.inf]
    add("eligible-0-1-2-4x128", 4, 128, 127, 7, 24, edit=few)
    # pos < window: no slot is eligible in any lane
    add("pos-lt-window-2x64", 2, 64, [3, 15], [1, 2], 25,
        cfg=_quantile_cfg(window=16))

    def one_slot(rng, x):
        x["frozen"][:] = [[False], [True]]
    add("s1-2x1", 2, 1, [0, 0], [3, 4], 26, cfg=_quantile_cfg(window=0),
        edit=one_slot)
    add("ragged-4x2049", 4, 2049, [2048, 2000, 1033, 5], [9, 63, 4, 1], 27)
    for S in (8192, 32768):
        add(f"long-4x{S}", 4, S, [S - 1, S - 300, S // 2 + 17, 700],
            [255, 100, 17, 3], 28, cfg=_quantile_cfg(window=16, history=256))
    # the Table-1 protocol's cache and settings: one lane, scalar clocks
    add("table1-1x560", 1, 560, 530, 515, 29,
        cfg=_quantile_cfg(window=16, history=256))

    # tests/test_freeze.py's quantile rows: lane b has exactly b eligible
    # slots (b = 0..63), scores up to 1000, so the f32 rank q * (b - 1)
    # lands just off an integer on some lanes
    def ranks(rng, x):
        x["frozen"][:] = False
        x["relevance"] = (rng.rand(64, 68) * 1000).astype(np.float32)
    for q in (0.35, 0.45, 0.6):
        add(f"rank-q{q}-64x68", 64, 68, np.arange(64) + 3,
            np.arange(64) % 7, 30, cfg=_quantile_cfg(window=4, quantile=q),
            edit=ranks)

    # the same rows drawn from three random values: the two order
    # statistics tie, so tau must come out as that value to the ulp; a
    # blend rounded twice in f32 misses it on some lanes and flips the
    # slots equal to it (seed 31 does so at each of the three quantiles)
    def tied(rng, x):
        x["frozen"][:] = False
        vals = rng.rand(3).astype(np.float32)
        x["relevance"] = vals[rng.randint(0, 3, (64, 68))]
    for q in (0.35, 0.45, 0.6):
        add(f"tied-rank-q{q}-64x68", 64, 68, np.arange(64) + 3,
            np.arange(64) % 7, 31, cfg=_quantile_cfg(window=4, quantile=q),
            edit=tied)
    return out


def freeze_args(case: FreezeCase, device):
    """(FreezeState, relevance, pos, step) tensors on ``device``."""
    t = {k: torch.from_numpy(np.asarray(v)).to(device)
         for k, v in case.inputs.items()}
    st = FreezeState(c=t["c"], d=t["d"], frozen=t["frozen"],
                     frozen_at=t["frozen_at"])
    return (st, t["relevance"], torch.as_tensor(case.pos, device=device),
            torch.as_tensor(case.step, device=device))

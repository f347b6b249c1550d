"""Config dataclasses for models, freezing (ASR-KF-EGR) and runtime shapes.

Every assigned architecture gets one module in this package defining
``CONFIG = ModelConfig(...)`` with the exact published dimensions (source
cited in the module docstring).  ``tiny()`` derives the reduced variant used
by CPU smoke tests (<=2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class FreezeConfig:
    """Hyperparameters of ASR-KF-EGR (paper §4.1 defaults).

    window:   sliding window K of most-recent tokens never considered for
              freezing (paper: K=32).
    tau:      relevance threshold; tokens with mean |Q.K| below it are
              low-importance candidates (paper: 0.50).
    k_soft:   softness parameter k in d = floor(sqrt(c)/k) (paper: 2.0).
    history:  history window W for the detection counter c (paper §3.4).
              Realized as a periodic decrement: every ``history`` steps each
              counter decays by 1 so stale detections age out.
    page_size:         tokens per KV page for the batched host-offload path.
    max_active_pages:  device-resident page budget per sequence for the
                       bounded-active (long-context) serving mode; 0 = uncapped.
    """

    window: int = 32
    tau: float = 0.50
    k_soft: float = 2.0
    history: int = 256
    # --- beyond-paper: adaptive threshold (DESIGN.md §2) ---
    # "fixed": paper-faithful tau.  "quantile": per-sequence, per-step
    # threshold = the `quantile` quantile of eligible relevance scores, so
    # the flag rate (and hence compression) is scale-invariant — removes
    # the paper's §6 threshold-sensitivity limitation.
    tau_mode: str = "fixed"
    quantile: float = 0.35
    page_size: int = 64
    max_active_pages: int = 0
    # --- entropy-guided recovery (paper §3.6; implemented here) ---
    recovery_enabled: bool = True
    entropy_abs_threshold: float = 4.0     # nats; hard spike level
    entropy_rel_factor: float = 1.75       # spike if H > factor * EMA(H)
    entropy_ema_decay: float = 0.95
    recovery_window: int = 64              # N for Window Reset
    rewalk_tokens: int = 8                 # k for Rewalk Regeneration
    calm_steps_to_deescalate: int = 16


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                  # query heads; 0 for attention-free (ssm)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # ---- MoE ----
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1              # MoE FFN on layers with l % moe_every == moe_offset
    moe_offset: int = 0
    # ---- hybrid (jamba): one attention layer per `attn_every` layers ----
    attn_every: int = 0             # 0 = attention everywhere (or ssm everywhere)
    # ---- mamba ----
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0          # 0 -> ceil(d_model/16)
    # ---- rwkv6 ----
    rwkv_head_dim: int = 64
    # ---- encoder-decoder (whisper) ----
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_frames: int = 1500      # stub conv-frontend output length
    # ---- multimodal stub (early-fusion VLMs) ----
    multimodal: bool = False
    num_patches: int = 256          # stub patch-embedding prefix length
    # ---- misc ----
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # §Perf H2: decode-time activation-gather mode for models whose weights
    # exceed the resident budget under tensor-only sharding.  Activations are
    # replicated over the fsdp axis at the block entry (KBs for a decode
    # step) so the 2-D-sharded weights stay RESIDENT — the per-step FSDP
    # weight all-gather (GBs) disappears.  Set by launch/specs.py.
    decode_act_gather: bool = False
    # §Perf H5: explicit activation sharding constraints (batch axes + model
    # partitions) — defeats SPMD "involuntary full rematerialization" of
    # batch-replicated activations inside scanned mamba/attention bodies.
    # Set by launch/specs.py; empty tuple = no constraints (baseline).
    act_batch_axes: Tuple[str, ...] = ()
    act_model_parts: int = 0
    # §Perf H1: remat chunk for the Mamba selective-scan time dimension
    # during training (0 = plain scan, saves every per-step carry for the
    # backward pass).  Set by launch/specs.py for train bundles.
    mamba_scan_chunk: int = 0
    source: str = ""                # citation
    freeze: FreezeConfig = dataclasses.field(default_factory=FreezeConfig)

    # ------------------------------------------------------------------ #
    @property
    def attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (Megatron-style) so the vocab
        dim shards cleanly over 16-way tensor axes (whisper: 51865->51968)."""
        return -(-self.vocab_size // 128) * 128

    def is_attn_layer(self, layer: int) -> bool:
        if self.arch_type == "ssm":
            return False
        if self.attn_every <= 1:
            return True
        return layer % self.attn_every == 0

    def is_moe_layer(self, layer: int) -> bool:
        if self.num_experts == 0:
            return False
        return layer % self.moe_every == self.moe_offset

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for roofline
        MODEL_FLOPS = 6*N*D."""
        n = self.padded_vocab * self.d_model  # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * self.d_model  # lm head
        n += self._block_params(active_only=False)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        n = self.padded_vocab * self.d_model
        if not self.tie_embeddings:
            n += self.padded_vocab * self.d_model
        n += self._block_params(active_only=True)
        return n

    def _block_params(self, active_only: bool) -> int:
        d, f = self.d_model, self.d_ff
        total = 0
        for l in range(self.num_layers):
            if self.is_attn_layer(l):
                total += d * self.num_heads * self.head_dim * 2          # wq, wo
                total += d * self.num_kv_heads * self.head_dim * 2       # wk, wv
            elif self.arch_type in ("hybrid",):                          # mamba layer
                di = self.mamba_expand * d
                total += d * 2 * di + di * self.mamba_d_conv
                total += di * (self.dt_rank + 2 * self.mamba_d_state)
                total += self.dt_rank * di + di * self.mamba_d_state + di
                total += di * d
            if self.arch_type == "ssm":                                  # rwkv6 block
                total += 4 * d * d + d * d                               # r,k,v,g,o
                total += d * f + f * d                                   # channel mix
                continue
            # FFN
            ffn = 3 * d * f                                              # swiglu
            if self.is_moe_layer(l):
                e = self.experts_per_token if active_only else self.num_experts
                total += ffn * e + d * self.num_experts                  # experts + router
            else:
                total += ffn
            total += 2 * d                                               # norms
        return total

    def tiny(self) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests."""
        d = min(self.d_model, 256)
        heads = 4 if self.num_heads else 0
        kvh = min(self.num_kv_heads, 2) if self.num_kv_heads else 0
        if self.num_kv_heads == 1:
            kvh = 1  # preserve MQA-ness
        return dataclasses.replace(
            self,
            name=self.name + "-tiny",
            num_layers=2,
            attn_every=min(self.attn_every, 2),
            d_model=d,
            num_heads=heads,
            num_kv_heads=kvh,
            head_dim=d // heads if heads else 64,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_frames=min(self.encoder_frames, 64),
            num_patches=min(self.num_patches, 8),
            rwkv_head_dim=min(self.rwkv_head_dim, 64),
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

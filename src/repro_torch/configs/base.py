"""Model / run configuration dataclasses.

Every assigned architecture instantiates :class:`ModelConfig`; shape points
(seq_len x global_batch x mode) are :class:`ShapeConfig`.  Configs are plain
frozen dataclasses so they hash, print, and diff cleanly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # -- attention ---------------------------------------------------------
    attn_bias: bool = False            # qwen2-style QKV bias
    attn_logit_softcap: float = 0.0    # grok-style tanh soft-capping (0 = off)
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0         # chatglm applies rotary to half the dims
    sliding_window: int = 0            # mixtral SWA window (0 = full attention)

    # -- MoE ---------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25

    # -- SSM (mamba-2 / SSD) ------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # -- hybrid (recurrentgemma / griffin) -----------------------------------
    block_pattern: tuple[str, ...] = ("attn",)   # cycled over layers
    local_window: int = 0                        # griffin local-attn window
    rglru_width: int = 0                         # RG-LRU recurrent width
    rglru_conv: int = 4

    # -- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_len: int = 1500            # whisper 30 s of audio -> 1500 frames

    # -- VLM (internvl stub) --------------------------------------------------
    num_patches: int = 0               # precomputed patch embeddings prefix

    # -- misc ----------------------------------------------------------------
    norm_eps: float = 1e-5
    act: str = "silu"                  # silu | gelu | geglu-style gating below
    gated_mlp: bool = True             # SwiGLU/GeGLU two-matrix gate
    tie_embeddings: bool = False
    use_layer_norm: bool = False       # whisper uses LayerNorm, others RMSNorm
    dtype: str = "bfloat16"
    remat: str = "layer"               # layer | none
    #: Unroll lax.scan loops (layer stack, attention q-chunks, SSD chunks).
    #: The dry-run sets this so compiled cost_analysis counts every
    #: iteration (XLA costs a while-loop body exactly once); runtime keeps
    #: scans rolled for small HLO and fast compiles.
    unroll_scans: bool = False
    #: Query-chunk length for memory-efficient attention (0 = module
    #: default).  Perf knob: under sequence parallelism a single chunk
    #: (= seq_len) avoids resharding collectives from chunked slicing.
    attn_q_chunk: int = 0
    #: KV-cache storage dtype: "bfloat16" or "int8" (per-token, per-head
    #: symmetric scales — the paper's int8-inference-engine insight applied
    #: to the serving cache: halves cache bytes and decode HBM traffic).
    kv_cache_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if memory/compute per decoded token is o(seq_len)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window > 0
        )

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer block kind, cycling block_pattern (decoder stack)."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    # -- analytic parameter / FLOP accounting (used by roofline + docs) ----
    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        n_q, n_kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
        mlp = (3 if self.gated_mlp else 2) * d * ff
        if self.num_experts:
            mlp *= self.num_experts
            mlp += d * self.num_experts  # router
        per_kind = {}
        per_kind["attn"] = attn + mlp + 2 * d
        per_kind["local_attn"] = per_kind["attn"]
        if self.family == "ssm":
            di, st = self.ssm_d_inner, self.ssm_state
            ssm = d * (2 * di + 2 * self.ssm_ngroups * st + self.ssm_nheads)
            ssm += self.ssm_conv * (di + 2 * self.ssm_ngroups * st)
            ssm += di * d + 3 * self.ssm_nheads  # out proj + A/dt/D params
            per_kind["ssm"] = ssm + 2 * d
        if "rec" in self.block_pattern:
            w = self.rglru_width or d
            rec = d * w * 2 + self.rglru_conv * w + 2 * w * 2 + w * d
            rec += mlp + 2 * d
            per_kind["rec"] = rec
        total = sum(per_kind.get(k, per_kind.get("attn", 0))
                    for k in self.layer_kinds())
        if self.is_encoder_decoder:
            # encoder self-attn + mlp; decoder adds cross-attn
            total += self.num_encoder_layers * (attn + mlp + 2 * d)
            total += self.num_layers * (attn + 2 * d)  # cross attention
        total += v * d  # embeddings
        if not self.tie_embeddings:
            total += v * d
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE uses top-k of experts)."""
        if not self.num_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_mlp = (3 if self.gated_mlp else 2) * d * ff
        inactive = (self.num_experts - self.num_experts_per_tok) * dense_mlp
        return int(self.param_count() - self.num_layers * inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether the (arch, shape) cell runs; reason recorded in EXPERIMENTS.md."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full O(L^2) attention; 512k decode requires sub-quadratic memory"
    return True, ""


def pad_to(x: int, multiple: int) -> int:
    return int(math.ceil(x / multiple) * multiple)

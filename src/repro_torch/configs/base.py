"""Architecture + shape configuration for the HAPT framework.

Every assigned architecture is described by one :class:`ArchConfig`. The config
is the single source of truth consumed by

- ``models.api.build_model``       (functional model construction)
- ``core.opgraph.build_op_sequence`` (planner IR: per-op flops/bytes/params)
- ``launch.dryrun``                (input_specs + sharded lower/compile)
- smoke tests                      (``cfg.reduced()``)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell.

    ``kind`` selects which step gets lowered: ``train`` -> train_step,
    ``prefill`` -> prefill forward, ``decode`` -> serve_step (one new token
    against a KV cache / SSM state of ``seq_len``).
    """

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    # identity -------------------------------------------------------------
    arch_id: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'vlm' | 'audio' | 'hybrid'
    source: str = ""

    # transformer dims -------------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0          # 0 -> d_model // n_heads
    d_ff: int = 0              # per-expert ff dim for MoE
    vocab_size: int = 0
    activation: str = "swiglu"  # 'swiglu' | 'geglu' | 'relu2' | 'gelu'
    tie_embeddings: bool = False
    scale_embed: bool = False      # gemma-style sqrt(d_model) embedding scale
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0

    # attention pattern ------------------------------------------------------
    sliding_window: int = 0        # 0 -> full attention
    local_global_ratio: int = 0    # e.g. 5 -> 5 local layers per 1 global
    max_position: int = 131_072

    # MoE ----------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba-2 / SSD) ------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2): shared transformer block applied every k SSM layers ----
    shared_attn_every: int = 0

    # VLM: cross-attention image layers every k layers -------------------------
    cross_attn_every: int = 0
    n_image_tokens: int = 1601     # stub patch-embedding count (1 tile)

    # enc-dec (whisper) --------------------------------------------------------
    enc_layers: int = 0            # >0 -> encoder-decoder; n_layers = decoder
    enc_frames: int = 1500         # stub frame-embedding count

    # ---------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # derived dims ---------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """Mamba-2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (needs sub-quadratic attention)."""
        if self.family in ("ssm", "hybrid"):
            return True
        # local:global mixes (gemma3) are dominated by windowed layers
        return self.local_global_ratio > 0

    def shapes(self) -> Tuple[ShapeSpec, ...]:
        """The assigned shape cells applicable to this arch."""
        out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.sub_quadratic:
            out.append(LONG_500K)
        return tuple(out)

    # parameter accounting ----------------------------------------------------
    def _attn_params(self) -> int:
        return self.d_model * (self.q_dim + 2 * self.kv_dim) + self.q_dim * self.d_model

    def _mlp_params(self, d_ff: Optional[int] = None) -> int:
        ff = self.d_ff if d_ff is None else d_ff
        gated = self.activation in ("swiglu", "geglu")
        n_in = 2 if gated else 1
        return self.d_model * ff * (n_in + 1)

    def _ssd_params(self) -> int:
        d_in, d_st, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
        # in_proj -> [z, x, B, C, dt], conv, norm, out_proj  (Mamba-2 fused proj)
        proj_in = self.d_model * (2 * d_in + 2 * d_st + nh)
        conv = self.ssm_conv * (d_in + 2 * d_st)
        out = d_in * self.d_model
        heads = 2 * nh  # A_log, D
        return proj_in + conv + out + heads + d_in

    def _block_params(self, layer_idx: int = 0) -> int:
        """Parameters of one repeated block (family-dependent)."""
        norm = 2 * self.d_model
        if self.family == "ssm":
            return self._ssd_params() + self.d_model
        if self.family == "hybrid":
            return self._ssd_params() + self.d_model
        if self.family == "moe":
            router = self.d_model * self.n_experts
            experts = self.n_experts * self._mlp_params()
            return self._attn_params() + router + experts + norm
        return self._attn_params() + self._mlp_params() + norm

    def param_count(self) -> int:
        """Total parameter count (embeddings included)."""
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        total = emb + self.d_model  # final norm
        total += self.n_layers * self._block_params()
        if self.family == "hybrid" and self.shared_attn_every:
            # one shared transformer block (attn + mlp), params counted once
            total += self._attn_params() + self._mlp_params() + 2 * self.d_model
            # per-application linear adapters from/to backbone width
            n_app = self.n_layers // self.shared_attn_every
            total += n_app * 2 * self.d_model * self.d_model
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (self._attn_params() + 2 * self.d_model)
        if self.enc_layers:
            total += self.enc_layers * (self._attn_params() + self._mlp_params() + norm_p(self))
            total += self.n_layers * (self._attn_params() + self.d_model)  # dec cross-attn
            total += self.enc_frames * 0  # frontend stubbed
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        dense = self.param_count() - self.n_layers * self.n_experts * self._mlp_params()
        return int(dense + self.n_layers * self.top_k * self._mlp_params())

    # reduced config for smoke tests -------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config: one forward/train step runs on CPU."""
        r = {
            "n_layers": min(self.n_layers, 4),
            "d_model": 64,
            "n_heads": max(2, min(self.n_heads, 4)),
            "n_kv_heads": max(1, min(self.n_kv_heads, 2)),
            "head_dim": 16,
            "d_ff": 128,
            "vocab_size": 512,
            "max_position": 1024,
        }
        if self.n_experts:
            r["n_experts"] = 4
            r["top_k"] = 2
        if self.ssm_state:
            r["ssm_state"] = 16
            r["ssm_head_dim"] = 16
            r["ssm_chunk"] = 32
        if self.sliding_window:
            r["sliding_window"] = 64
        if self.local_global_ratio:
            r["local_global_ratio"] = 2
            r["n_layers"] = 6  # two groups of (2 local + 1 global)
        if self.shared_attn_every:
            r["shared_attn_every"] = 2
        if self.cross_attn_every:
            r["cross_attn_every"] = 2
            r["n_image_tokens"] = 16
        if self.enc_layers:
            r["enc_layers"] = 2
            r["enc_frames"] = 32
        return dataclasses.replace(self, arch_id=self.arch_id + "-smoke", **r)


def norm_p(cfg: ArchConfig) -> int:
    return 2 * cfg.d_model

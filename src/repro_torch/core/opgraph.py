"""Operator-sequence IR for the planner.

``build_op_sequence(cfg)`` linearizes an architecture into a topologically
ordered list of :class:`Op` (the planner's input, mirroring Alpa/HAPT).
Each op carries analytic per-token flops / parameter bytes / boundary
activation bytes; ``signature`` is the structural identity used by
repeated-module mining and zero-redundant aliasing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class Op:
    name: str
    signature: str            # structural identity (kind + dims)
    flops_per_token: float    # forward flops
    param_bytes: float
    act_bytes_per_token: float  # bytes of this op's *output* per token
    heavy: bool = False       # GEMM/conv-like (drives module mining)


def _gemm(name: str, sig: str, d_in: int, d_out: int, bytes_per: int = 2,
          out_width: int | None = None) -> Op:
    width = d_out if out_width is None else out_width
    return Op(name, sig, 2.0 * d_in * d_out, bytes_per * d_in * d_out,
              bytes_per * width, heavy=True)


def _light(name: str, sig: str, width: int, flops_mult: float = 4.0,
           param: float = 0.0, bytes_per: int = 2) -> Op:
    return Op(name, sig, flops_mult * width, param, bytes_per * width)


def _attn_ops(cfg: ArchConfig, tag: str, seq_len: int, causal_frac: float,
              cross: bool = False, window: int = 0) -> List[Op]:
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    eff_seq = min(seq_len, window) if window else seq_len
    core_flops = 2.0 * 2.0 * qd * eff_seq * causal_frac  # QK^T + PV per token
    return [
        _light(f"{tag}.ln", f"ln[{d}]", d),
        _gemm(f"{tag}.qkv", f"attn.qkv[{d}->{qd}+{2*kvd}]", d, qd + 2 * kvd,
              out_width=qd + 2 * kvd),
        Op(f"{tag}.core", f"attn.core[{qd}x{eff_seq}]", core_flops, 0.0,
           2.0 * qd, heavy=True),
        _gemm(f"{tag}.out", f"attn.o[{qd}->{d}]", qd, d),
    ]


def _mlp_ops(cfg: ArchConfig, tag: str) -> List[Op]:
    d, ff = cfg.d_model, cfg.d_ff
    gated = cfg.activation in ("swiglu", "geglu")
    ops = [_light(f"{tag}.ln", f"ln[{d}]", d),
           _gemm(f"{tag}.up", f"mlp.up[{d}->{ff}]", d, ff)]
    if gated:
        ops.append(_gemm(f"{tag}.gate", f"mlp.gate[{d}->{ff}]", d, ff))
    ops.append(_light(f"{tag}.act", f"act[{ff}]", ff))
    ops.append(_gemm(f"{tag}.down", f"mlp.down[{ff}->{d}]", ff, d))
    return ops


def _moe_ops(cfg: ArchConfig, tag: str) -> List[Op]:
    d, ff, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    gated = cfg.activation in ("swiglu", "geglu")
    n_mats = 3 if gated else 2
    # router + dispatched expert compute (top-k of E experts per token)
    return [
        _light(f"{tag}.ln", f"ln[{d}]", d),
        Op(f"{tag}.router", f"moe.router[{d}->{E}]", 2.0 * d * E, 4.0 * d * E,
           4.0 * E),
        Op(f"{tag}.experts", f"moe.experts[{E}x{d}x{ff}]",
           2.0 * k * n_mats * d * ff, 2.0 * E * n_mats * d * ff, 2.0 * d,
           heavy=True),
    ]


def _ssm_ops(cfg: ArchConfig, tag: str) -> List[Op]:
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    dproj = 2 * di + 2 * ns + nh
    q = cfg.ssm_chunk
    # intra-chunk: CB (Q*N) + M@x (Q*P per head) ~= 2*Q*(N + P)*di-ish per token
    ssd_flops = 2.0 * q * (ns + di) + 4.0 * di * ns
    return [
        _light(f"{tag}.ln", f"ln[{d}]", d),
        _gemm(f"{tag}.inproj", f"ssm.in[{d}->{dproj}]", d, dproj),
        _light(f"{tag}.conv", f"conv[{di + 2 * ns}]", di + 2 * ns,
               flops_mult=2.0 * cfg.ssm_conv,
               param=2.0 * cfg.ssm_conv * (di + 2 * ns)),
        Op(f"{tag}.ssd", f"ssm.ssd[{di}x{ns}x{q}]", ssd_flops,
           16.0 * nh, 2.0 * di, heavy=True),
        _gemm(f"{tag}.outproj", f"ssm.out[{di}->{d}]", di, d),
    ]


def build_op_sequence(cfg: ArchConfig, seq_len: int = 4096) -> List[Op]:
    """Linearized operator sequence for the whole model (training graph)."""
    d, V = cfg.d_model, cfg.vocab_size
    ops: List[Op] = [
        Op("embed", f"embed[{V}x{d}]", 0.0, 2.0 * V * d, 2.0 * d),
    ]
    causal_frac = 0.5  # average causal coverage

    if cfg.family == "audio":
        for l in range(cfg.enc_layers):
            tag = f"enc{l}"
            ops += _attn_ops(cfg, f"{tag}.attn", cfg.enc_frames, 1.0)
            ops += _mlp_ops(cfg, f"{tag}.mlp")
        for l in range(cfg.n_layers):
            tag = f"dec{l}"
            ops += _attn_ops(cfg, f"{tag}.self", seq_len, causal_frac)
            ops += _attn_ops(cfg, f"{tag}.cross", cfg.enc_frames, 1.0, cross=True)
            ops += _mlp_ops(cfg, f"{tag}.mlp")
    elif cfg.family == "ssm":
        for l in range(cfg.n_layers):
            ops += _ssm_ops(cfg, f"l{l}")
    elif cfg.family == "hybrid":
        n_apps = cfg.n_layers // cfg.shared_attn_every
        li = 0
        for l in range(cfg.n_layers):
            ops += _ssm_ops(cfg, f"l{l}")
            if (l + 1) % cfg.shared_attn_every == 0 and li < n_apps:
                tag = f"shared{li}"
                ops.append(_gemm(f"{tag}.adapt_in", f"adapt[{d}->{d}]", d, d))
                ops += _attn_ops(cfg, f"{tag}.attn", seq_len, causal_frac)
                ops += _mlp_ops(cfg, f"{tag}.mlp")
                ops.append(_gemm(f"{tag}.adapt_out", f"adapt[{d}->{d}]", d, d))
                li += 1
    elif cfg.family == "moe":
        for l in range(cfg.n_layers):
            tag = f"l{l}"
            ops += _attn_ops(cfg, f"{tag}.attn", seq_len, causal_frac)
            ops += _moe_ops(cfg, f"{tag}.moe")
    elif cfg.family == "vlm":
        gsz = cfg.cross_attn_every
        for l in range(cfg.n_layers):
            tag = f"l{l}"
            if (l + 1) % gsz == 0:
                ops += _attn_ops(cfg, f"{tag}.xattn", cfg.n_image_tokens, 1.0,
                                 cross=True)
                ops += _mlp_ops(cfg, f"{tag}.mlp")
            else:
                ops += _attn_ops(cfg, f"{tag}.attn", seq_len, causal_frac)
                ops += _mlp_ops(cfg, f"{tag}.mlp")
    else:  # dense
        ratio = cfg.local_global_ratio
        for l in range(cfg.n_layers):
            tag = f"l{l}"
            if ratio and (l + 1) % (ratio + 1) != 0:
                w = cfg.sliding_window
            else:
                w = cfg.sliding_window if not ratio and cfg.sliding_window else 0
            ops += _attn_ops(cfg, f"{tag}.attn", seq_len, causal_frac, window=w)
            ops += _mlp_ops(cfg, f"{tag}.mlp")

    ops.append(_light("final.ln", f"ln[{d}]", d))
    head_param = 0.0 if cfg.tie_embeddings else 2.0 * d * V
    ops.append(Op("lm_head", f"head[{d}->{V}]", 2.0 * d * V, head_param,
                  2.0 * V, heavy=True))
    return ops


def total_flops_per_token(ops: List[Op]) -> float:
    return sum(o.flops_per_token for o in ops)


def total_param_bytes(ops: List[Op]) -> float:
    return sum(o.param_bytes for o in ops)

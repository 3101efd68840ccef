"""The 10 assigned architectures (exact published dims) + the paper's GPT configs."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

# --- dense ------------------------------------------------------------------

MINITRON_8B = ArchConfig(
    arch_id="minitron-8b", family="dense", source="arXiv:2407.14679",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=256000, activation="relu2",  # nemotron squared-ReLU
    rope_theta=10_000.0,
)

DEEPSEEK_7B = ArchConfig(
    arch_id="deepseek-7b", family="dense", source="arXiv:2401.02954",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=102400, activation="swiglu",
)

GEMMA_2B = ArchConfig(
    arch_id="gemma-2b", family="dense", source="arXiv:2403.08295",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000, activation="geglu", tie_embeddings=True,
    scale_embed=True,
)

GEMMA3_12B = ArchConfig(
    arch_id="gemma3-12b", family="dense", source="hf:google/gemma-3 (unverified)",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144, activation="geglu", tie_embeddings=True,
    scale_embed=True,
    sliding_window=1024, local_global_ratio=5, max_position=131_072,
    rope_theta=1_000_000.0,
)

# --- MoE ----------------------------------------------------------------------

QWEN3_MOE = ArchConfig(
    arch_id="qwen3-moe-235b-a22b", family="moe", source="hf:Qwen/Qwen3 (hf)",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936, activation="swiglu",
    n_experts=128, top_k=8, rope_theta=1_000_000.0,
)

GRANITE_MOE = ArchConfig(
    arch_id="granite-moe-1b-a400m", family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (hf)",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, activation="swiglu",
    n_experts=32, top_k=8, tie_embeddings=True,
)

# --- SSM ------------------------------------------------------------------------

MAMBA2_27B = ArchConfig(
    arch_id="mamba2-2.7b", family="ssm", source="arXiv:2405.21060 (unverified)",
    n_layers=64, d_model=2560, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    tie_embeddings=True,
)

# --- VLM -------------------------------------------------------------------------

LLAMA32_VISION_90B = ArchConfig(
    arch_id="llama-3.2-vision-90b", family="vlm",
    source="hf:meta-llama/Llama-3.2-Vision (unverified)",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, activation="swiglu",
    cross_attn_every=5, n_image_tokens=1601, rope_theta=500_000.0,
)

# --- audio (enc-dec) ---------------------------------------------------------------

WHISPER_MEDIUM = ArchConfig(
    arch_id="whisper-medium", family="audio", source="arXiv:2212.04356 (unverified)",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865, activation="gelu",
    enc_layers=24, enc_frames=1500, rope_theta=0.0,  # absolute pos embeddings
)

# --- hybrid ---------------------------------------------------------------------------

ZAMBA2_7B = ArchConfig(
    arch_id="zamba2-7b", family="hybrid", source="arXiv:2411.15242 (unverified)",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000, activation="swiglu",
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    shared_attn_every=6,
)

# --- the paper's own GPT family (HAPT §6: 15B-39B, seq 1k, GBS 1024) ---------------

GPT_2B = ArchConfig(
    arch_id="gpt-2b", family="dense", source="HAPT paper §2.2.2 case study scale",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=51200, activation="gelu", max_position=1024,
)
GPT_15B = ArchConfig(
    arch_id="gpt-15b", family="dense", source="HAPT paper §6",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=20480, vocab_size=51200, activation="gelu", max_position=1024,
)
GPT_30B = ArchConfig(
    arch_id="gpt-30b", family="dense", source="HAPT paper §6",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=48,
    d_ff=24576, vocab_size=51200, activation="gelu", max_position=1024,
)
GPT_39B = ArchConfig(
    arch_id="gpt-39b", family="dense", source="HAPT paper §6 (#L=146 granularity)",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=64,
    d_ff=32768, vocab_size=51200, activation="gelu", max_position=1024,
)

ASSIGNED = (
    MINITRON_8B, DEEPSEEK_7B, GEMMA_2B, GEMMA3_12B, QWEN3_MOE, GRANITE_MOE,
    MAMBA2_27B, LLAMA32_VISION_90B, WHISPER_MEDIUM, ZAMBA2_7B,
)
PAPER = (GPT_2B, GPT_15B, GPT_30B, GPT_39B)

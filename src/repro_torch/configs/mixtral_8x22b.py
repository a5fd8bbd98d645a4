"""mixtral-8x22b [moe] — 8 experts top-2, SWA (arXiv:2401.04088; hf
mistralai/Mixtral-8x22B).

56L d_model=6144 48H (GQA kv=8) head_dim=128, expert d_ff=16384
vocab=32768, MoE 8e top-2, sliding window 4096 (mixtral-v0.1 style SWA
per the assignment).
Fields as in ``repro``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,               # per-expert ffn dim
    vocab_size=32_768,
    scan_pattern=("swa_moe",),
    scan_repeats=56,
    window=4096,
    num_experts=8,
    top_k=2,
    moe_d_ff=16384,
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

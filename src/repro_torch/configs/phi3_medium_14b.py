"""phi3-medium-14b [dense] — RoPE SwiGLU GQA (arXiv:2404.14219).

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352, head_dim=128.
Fields as in ``repro``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100_352,
    scan_pattern=("attn",),
    scan_repeats=40,
    mlp_act="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
)

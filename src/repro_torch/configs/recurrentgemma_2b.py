"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2:1 pattern
(arXiv:2402.19427; hf google/recurrentgemma-2b).

26L d_model=2560 10H (GQA kv=1) head_dim=256 d_ff=7680 (GeGLU),
lru_width=2560, local attention window 2048, vocab 256000.
Pattern (rec, rec, attn) x 8 + (rec, rec) = 26 layers.  Fields as in
``repro``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    scan_pattern=("rglru", "rglru", "attn_local"),
    scan_repeats=8,
    suffix_kinds=("rglru", "rglru"),
    window=2048,
    lru_width=2560,
    mlp_act="geglu",
    scale_embeddings=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
)

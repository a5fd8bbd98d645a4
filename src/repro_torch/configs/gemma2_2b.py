"""gemma2-2b [dense] — local/global alternating attention, logit softcaps
(arXiv:2408.00118; hf google/gemma-2-2b).

26L d_model=2304 8H (GQA kv=4) head_dim=256 d_ff=9216 vocab=256000,
window 4096 on local layers, attn softcap 50, final softcap 30,
GeGLU, sandwich norms, sqrt(d_model) embedding scale.
Fields as in ``repro``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    scan_pattern=("local", "global"),
    scan_repeats=13,
    window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_act="geglu",
    post_norms=True,
    scale_embeddings=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
)

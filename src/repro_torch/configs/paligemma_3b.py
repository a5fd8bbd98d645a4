"""paligemma-3b [vlm] — SigLIP + gemma backbone (arXiv:2407.07726; hf
google/paligemma-3b).

LM backbone only: 18L d_model=2048 8H (GQA kv=1)
head_dim=256 d_ff=16384 vocab=257216.  The SigLIP frontend is a STUB —
the serving engine feeds 256 zero patch embeddings (224px / patch 14,
``ServeEngine.extra_inputs``), prepended as a bidirectional prefix
(prefix-LM masking).  Fields as in ``repro``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257_216,
    scan_pattern=("attn",),
    scan_repeats=18,
    num_vision_tokens=256,
    mlp_act="geglu",
    scale_embeddings=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
)

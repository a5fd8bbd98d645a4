"""minitron-8b [dense] — pruned Nemotron-4 (arXiv:2407.14679; hf
nvidia/Minitron-8B-Base).

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000, head_dim=128,
squared-ReLU MLP in Nemotron; the substrate's gated form is used with the
published dims (systems-equivalent FLOP shape), as in ``repro``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256_000,
    scan_pattern=("attn",),
    scan_repeats=32,
    mlp_act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=False,
)

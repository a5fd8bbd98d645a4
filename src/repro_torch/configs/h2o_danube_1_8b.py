"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention
(arXiv:2401.16818; hf h2oai/h2o-danube-1.8b).

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, head_dim=80,
SWA window 4096 (mistral-style) on every layer.
Fields as in ``repro``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32_000,
    scan_pattern=("swa",),
    scan_repeats=24,
    window=4096,
    mlp_act="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
)

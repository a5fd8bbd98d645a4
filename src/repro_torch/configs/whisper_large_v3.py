"""whisper-large-v3 [audio] — enc-dec backbone, conv frontend stubbed
(arXiv:2212.04356).

32 encoder + 32 decoder layers, d_model=1280 20H (kv=20, MHA) head_dim=64,
d_ff=5120, vocab 51866.  The mel/conv frontend is a STUB: the serving
engine feeds zero frame embeddings (``ServeEngine.extra_inputs``);
encoder length 1536 (1500 native frames padded to the attention chunk
grid).  Fields as in ``repro``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,            # decoder layers
    encoder_layers=32,
    encoder_seq=1536,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    scan_pattern=("dec",),
    scan_repeats=32,
    mlp_act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

"""mamba2-780m [ssm] — SSD state-space duality (arXiv:2405.21060).

48L d_model=1536, attention-free (d_ff=0), vocab 50280, ssm_state=128.
Mamba2 defaults: expand=2 (d_inner=3072), head_dim=64 -> 48 SSD heads,
ngroups=1, conv kernel 4, chunk 256.  Fields as in ``repro``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    scan_pattern=("ssm",),
    scan_repeats=48,
    ssm_state=128,
    ssm_heads=48,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_kernel=4,
    expand=2,
    ssm_groups=1,
    tie_embeddings=True,
)

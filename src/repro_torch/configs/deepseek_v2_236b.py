"""deepseek-v2-236b [moe] — MLA + shared/routed MoE (arXiv:2405.04434; hf
deepseek-ai/DeepSeek-V2).

60L d_model=5120 128H, MLA kv_lora_rank=512 q_lora_rank=1536,
nope/v head_dim 128, rope head_dim 64; MoE: 2 shared + 160 routed experts,
top-6, expert d_ff=1536; vocab 102400.  First layer uses a dense MLP
(d_ff = 12288) per the released config, as in ``repro``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=12288,               # dense-MLP dim (layer 0)
    vocab_size=102_400,
    prefix_kinds=("mla_dense",),
    scan_pattern=("mla_moe",),
    scan_repeats=59,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    mlp_act="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
)

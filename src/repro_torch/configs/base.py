"""Model configs (port of ``repro.configs.base`` without jax).

``ModelConfig`` keeps every field of the reference so a config carries
across unchanged; ``get_config`` resolves the archs this port runs
(``PORTED``: every arch of the reference) and raises for any other name.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer-stack structure: prefix + pattern * repeats + suffix
    scan_pattern: tuple[str, ...] = ("attn",)
    scan_repeats: int = 0
    prefix_kinds: tuple[str, ...] = ()
    suffix_kinds: tuple[str, ...] = ()

    # attention variants
    window: int = 0                   # sliding/local window size
    attn_logit_softcap: float = 0.0   # gemma2
    final_logit_softcap: float = 0.0  # gemma2
    rope_theta: float = 10_000.0
    post_norms: bool = False          # gemma2 sandwich norms
    mlp_act: str = "swiglu"           # swiglu | geglu | gelu

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_chunk: int = 256
    conv_kernel: int = 4
    expand: int = 2
    ssm_groups: int = 1

    # hybrid (recurrentgemma)
    lru_width: int = 0

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0

    # vlm (paligemma)
    num_vision_tokens: int = 0

    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    scale_embeddings: bool = False    # gemma-family sqrt(d_model) scaling
    remat: bool = True
    remat_policy: str = "full"
    dtype: str = "bfloat16"

    # paper-technique integration switches (BNN mode)
    binarize_mlp: bool = False
    compress_weights: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)


# the archs this port runs: every LM arch of the reference and the BNN
PORTED = ("mamba2-780m", "gemma2-2b", "minitron-8b", "phi3-medium-14b",
          "h2o-danube-1.8b", "mixtral-8x22b", "deepseek-v2-236b",
          "recurrentgemma-2b", "paligemma-3b", "whisper-large-v3",
          "reactnet")


def get_config(name: str):
    """Resolve a ported arch name to its config object (ModelConfig, or
    ReActNetConfig for the BNN)."""
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet "
            f"(ported: {', '.join(PORTED)})")
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG

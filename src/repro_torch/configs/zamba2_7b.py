"""zamba2-7b — Zyphra Zamba2-7B [arXiv:2411.15242].

Hybrid Mamba2 + shared-attention LM: 81 layers, d_model 3584; every 6th
layer applies the SHARED attention block (one weight set, 13 applications:
32 heads GQA kv=32, paired MLP d_ff 14336); the other 68 layers are Mamba2
blocks with ssm_state=64. vocab 32000.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    rope_theta=10_000.0,
    attn_every=6,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=256),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-smoke", family="hybrid", n_layers=6,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        attn_every=3, ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk=32),
        dtype="float32")

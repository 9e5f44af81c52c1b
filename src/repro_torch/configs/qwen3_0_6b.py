"""qwen3-0.6b — Qwen3 0.6B [hf:Qwen/Qwen3-8B family].

Dense decoder LM: 28L, d_model 1024, 16 heads (GQA kv=8), d_ff 3072,
vocab 151936, qk-norm, explicit head_dim=128 (q_dim 2048 > d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-smoke", family="dense", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        head_dim=32, qk_norm=True, tie_embeddings=True, dtype="float32")

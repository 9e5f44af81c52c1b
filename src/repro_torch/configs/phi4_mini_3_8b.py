"""phi4-mini-3.8b — Microsoft Phi-4-mini [arXiv:2412.08905].

Dense decoder LM: 32L, d_model 3072, 24 heads (GQA kv=8), d_ff 8192,
vocab 200064, RoPE + SwiGLU.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="phi4-mini-smoke", family="dense", n_layers=2,
        d_model=48, n_heads=6, n_kv_heads=2, d_ff=96, vocab_size=320,
        dtype="float32")

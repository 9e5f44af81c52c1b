"""yi-6b — 01.AI Yi-6B [arXiv:2403.04652].

Llama-architecture dense LM: 32L, d_model 4096, 32 heads (GQA kv=4),
d_ff 11008, vocab 64000.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="yi-6b-smoke", family="dense", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=1, d_ff=172, vocab_size=256,
        dtype="float32")

"""granite-3-2b — IBM Granite 3.0 2B base [hf:ibm-granite/granite-3.0-2b-base].

Dense decoder LM: 40L, d_model 2048, 32 heads (GQA kv=8), d_ff 8192,
vocab 49155, SwiGLU + RoPE.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49_155,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-3-2b-smoke", family="dense", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        dtype="float32")

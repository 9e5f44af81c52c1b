"""phi3.5-moe-42b-a6.6b — Microsoft Phi-3.5-MoE [hf:microsoft/Phi-3.5-MoE-instruct].

MoE decoder LM: 32L, d_model 4096, 32 heads (GQA kv=8), per-expert
d_ff 6400, vocab 32064, 16 experts top-2.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=16, top_k=2),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="phi3.5-moe-smoke", family="moe", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=256,
        moe=MoEConfig(n_experts=4, top_k=2), dtype="float32")

"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

MoE decoder LM: 24L, d_model 2048, 16 heads (GQA kv=16), per-expert
d_ff 1408, vocab 151936, 60 routed experts top-4 + 4 shared experts
(shared hidden 5632 = 4x1408).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared_experts=4, shared_d_ff=1408),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2-moe-smoke", family="moe", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=256,
        moe=MoEConfig(n_experts=6, top_k=2, n_shared_experts=2, shared_d_ff=64),
        dtype="float32")

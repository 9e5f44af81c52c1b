"""mamba2-370m — Mamba2 370M, SSD state-space duality [arXiv:2405.21060].

Attention-free SSM: 48 Mamba2 layers, d_model 1024 (d_inner 2048, 32 SSM
heads x 64), ssm_state=128, vocab 50280. No MLP (pure Mamba2 stack).
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    use_rope=False,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=256),
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-smoke", family="ssm", n_layers=2,
        d_model=64, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=256,
        use_rope=False, tie_embeddings=True,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk=32),
        dtype="float32")

"""internvl2-26b — InternVL2 26B backbone [arXiv:2404.16821].

VLM: InternViT frontend is STUBBED (input_specs provides precomputed patch
embeddings); this config is the InternLM2-20B language backbone: 48L,
d_model 6144, 48 heads (GQA kv=8), d_ff 16384, vocab 92553. 256 visual
tokens are prepended to the text sequence.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_553,
    rope_theta=1_000_000.0,
    n_vis_tokens=256,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2-smoke", family="vlm", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        n_vis_tokens=8, dtype="float32")

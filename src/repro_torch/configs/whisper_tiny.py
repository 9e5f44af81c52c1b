"""whisper-tiny — OpenAI Whisper tiny [arXiv:2212.04356].

Encoder-decoder audio transformer BACKBONE: 4 encoder + 4 decoder layers,
d_model 384, 6 heads (kv=6), d_ff 1536, vocab 51865. The conv audio
frontend is a STUB — input_specs() provides precomputed frame embeddings
(seq_len/4 frames, matching the conv stride-2 x2 downsampling). Sinusoidal
positions (no RoPE), per the original.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family="enc_dec",
    n_layers=4,
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    use_rope=False,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-smoke", family="enc_dec", n_layers=2, n_enc_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        use_rope=False, dtype="float32")

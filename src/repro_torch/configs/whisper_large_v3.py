"""whisper-large-v3 backbone [arXiv:2212.04356].

Enc-dec transformer backbone only; the mel-spectrogram + conv frontend is a
stub — input_specs feeds precomputed (B, 1500, d_model) frame embeddings.
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-large-v3")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        kind="encdec",
        num_layers=32,
        num_encoder_layers=32,
        encoder_seq_len=1500,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        max_seq_len=448,
        source="arXiv:2212.04356",
    )

"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision].

Cross-attention image layers every 5th layer; ViT frontend is a stub —
input_specs feeds precomputed (B, num_image_tokens, d_model) patch
embeddings.
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama-3.2-vision-90b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        kind="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        cross_attn_every=5,
        num_image_tokens=1024,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )

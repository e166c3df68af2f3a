"""mamba2-370m [arXiv:2405.21060] — SSD (state-space duality), attn-free."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("mamba2-370m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        kind="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(state_size=128),
        tie_embeddings=True,
        source="arXiv:2405.21060",
    )

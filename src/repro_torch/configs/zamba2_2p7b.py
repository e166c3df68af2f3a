"""zamba2-2.7b [arXiv:2411.15242] — Mamba2 backbone + shared attn blocks."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("zamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        kind="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        ssm=SSMConfig(state_size=64),
        attn_every=6,  # one shared-weight attention block every 6 mamba layers
        source="arXiv:2411.15242",
    )

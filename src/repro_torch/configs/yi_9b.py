"""yi-9b [arXiv:2403.04652] — llama-arch with aggressive GQA (kv=4)."""
from repro_torch.configs.base import ModelConfig, register


@register("yi-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        kind="dense",
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        source="arXiv:2403.04652",
    )

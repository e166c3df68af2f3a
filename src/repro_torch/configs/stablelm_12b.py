"""stablelm-12b [hf:stabilityai/stablelm-2-1_6b family] — qk-norm."""
from repro_torch.configs.base import ModelConfig, register


@register("stablelm-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        kind="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=13824,
        vocab_size=100352,
        qk_norm=True,
        source="hf:stabilityai/stablelm-2-1_6b",
    )

"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B] — qwen1.5 arch (qkv bias)."""
from repro_torch.configs.base import ModelConfig, register


@register("codeqwen1.5-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        kind="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=13440,
        vocab_size=92416,
        qkv_bias=True,
        source="hf:Qwen/CodeQwen1.5-7B",
    )

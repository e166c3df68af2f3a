"""qwen2.5-7b — the paper's own reasoning-RL model family [arXiv Qwen2.5].

Used by the end-to-end examples and benchmarks (Fig. 8b analogue).
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2.5-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-7b",
        kind="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        source="arXiv:2412.15115 (Qwen2.5)",
    )

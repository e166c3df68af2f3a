"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("llama4-scout-17b-a16e")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        kind="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=0,
        vocab_size=202048,
        moe=MoEConfig(num_experts=16, top_k=1, expert_d_ff=8192,
                      shared_expert_d_ff=8192),
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
        notes="MoE top-1 with shared expert, early-fusion multimodal (text path)",
    )

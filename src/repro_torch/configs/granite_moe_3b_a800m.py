"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base].

32L d_model=1536 24H (GQA kv=8) expert d_ff=512 vocab=49155, MoE 40
experts top-8.  The HF card lists 32 experts; this copy keeps the JAX
package's 40.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("granite-moe-3b-a800m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        kind="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=0,
        vocab_size=49155,
        moe=MoEConfig(num_experts=40, top_k=8, expert_d_ff=512),
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )

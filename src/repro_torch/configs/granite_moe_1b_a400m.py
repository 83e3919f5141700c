"""granite-moe-1b-a400m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base.

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8.
"""
from repro_torch.configs import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        num_experts=32,
        experts_per_token=8,
        mlp_act="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
        attn_impl="ulysses",
    )

"""mistral-nemo-12b [dense] — hf:mistralai/Mistral-Nemo-Base-2407, 128k ctx.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
head_dim=128 (the real arch decouples head_dim from d_model/heads).
"""
from repro_torch.configs import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        mlp_act="swiglu",
        norm="rmsnorm",
        rope_theta=1000000.0,
        attn_impl="ulysses",
    )

"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 (arXiv:2402.19427).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, window=2048.
Block pattern cycles (rglru, rglru, local_attn).
"""
from repro_torch.configs import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        expand=1,  # lru_width == d_model in RG-9B
        block_pattern=("rglru", "rglru", "local_attn"),
        window=2048,
        mlp_act="gelu",
        norm="rmsnorm",
        attn_impl="ulysses",
    )

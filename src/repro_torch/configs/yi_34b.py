"""yi-34b [dense] — llama-arch GQA (arXiv:2403.04652).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
56 heads % 16 != 0 -> all-gather context parallelism (FPDT-CP).
"""
from repro_torch.configs import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        family="dense",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        mlp_act="swiglu",
        norm="rmsnorm",
        rope_theta=5000000.0,
        attn_impl="cp",
    )

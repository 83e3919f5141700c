"""qwen1.5-4b [dense] — QKV bias (hf:Qwen/Qwen1.5 family).

40L d_model=2560 20H (MHA kv=20) d_ff=6912 vocab=151936, QKV bias.
20 heads % 16 != 0 -> all-gather context parallelism (FPDT-CP).
"""
from repro_torch.configs import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,
        head_dim=128,
        d_ff=6912,
        vocab_size=151936,
        mlp_act="swiglu",
        norm="rmsnorm",
        qkv_bias=True,
        attn_impl="cp",
    )

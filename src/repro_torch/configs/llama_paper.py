"""Llama configs of the FPDT paper (8B / 70B): GQA with 8 kv heads,
head_dim 128, swiglu, rmsnorm, vocab 128256."""
from repro_torch.configs import ModelConfig

_DIMS = {
    "llama-8b": dict(num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, d_ff=14336,
                     vocab_size=128256),
    "llama-70b": dict(num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, d_ff=28672,
                      vocab_size=128256),
}


def config(name: str = "llama-8b") -> ModelConfig:
    dims = _DIMS[name]
    return ModelConfig(
        name=name,
        family="dense",
        head_dim=dims["d_model"] // dims["num_heads"],
        mlp_act="swiglu",
        norm="rmsnorm",
        rope_theta=500000.0,
        attn_impl="auto",
        **dims,
    )

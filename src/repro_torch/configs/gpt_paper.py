"""GPT configs of the FPDT paper (2.7B / 6.7B / 13B / 30B).

Standard GPT-3-family dims (Table 1, Fig. 11, Fig. 12, Table 3, Table 4):
multi-head attention, d_ff = 4 d_model, layernorm, gelu, vocab 50304.
gpt-2.7b has head_dim 80; the others 128.
"""
from repro_torch.configs import ModelConfig

_DIMS = {
    "gpt-2.7b": dict(num_layers=32, d_model=2560, num_heads=32),
    "gpt-6.7b": dict(num_layers=32, d_model=4096, num_heads=32),
    "gpt-13b": dict(num_layers=40, d_model=5120, num_heads=40),
    "gpt-30b": dict(num_layers=48, d_model=7168, num_heads=56),
}


def config(name: str = "gpt-2.7b") -> ModelConfig:
    dims = _DIMS[name]
    d = dims["d_model"]
    return ModelConfig(
        name=name,
        family="dense",
        num_kv_heads=dims["num_heads"],
        head_dim=d // dims["num_heads"],
        d_ff=4 * d,
        vocab_size=50304,
        mlp_act="gelu",
        norm="layernorm",
        attn_impl="auto",
        **dims,
    )

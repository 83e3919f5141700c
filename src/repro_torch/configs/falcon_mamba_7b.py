"""falcon-mamba-7b [ssm] — mamba1 arch, attention-free (arXiv:2410.05355).

64L d_model=4096 d_ff=0 vocab=65024, ssm_state=16, d_inner=2*d_model.
No attention heads: the `model` mesh axis shards SSM channels via the
sequence<->channel all-to-all (Ulysses-for-SSMs, DESIGN.md §3); FPDT maps to
the chunked sequential scan with carried SSM state.
"""
from repro_torch.configs import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        num_layers=64,
        d_model=4096,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=65024,
        ssm_state=16,
        d_conv=4,
        expand=2,
        mlp_act="swiglu",
        norm="rmsnorm",
        tie_embeddings=False,
        attn_impl="none",
    )

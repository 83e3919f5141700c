"""llama4-maverick-400b-a17b [moe] — MoE, early fusion (hf:meta-llama/Llama-4).

48L d_model=5120 40H (GQA kv=8) d_ff=8192/expert vocab=202048, MoE 128e top-1.
40 heads do not split over 16 ranks, so attention is all-gather context
parallelism (FPDT-CP); optimizer state in bf16.  At full size it holds
778 B parameters by ``num_params``, far beyond one card, so the port runs
its reduced form (``configs.reduced``).
"""
from repro_torch.configs import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        num_experts=128,
        experts_per_token=1,
        mlp_act="swiglu",
        norm="rmsnorm",
        rope_theta=500000.0,
        attn_impl="cp",
        opt_state_dtype="bfloat16",
    )

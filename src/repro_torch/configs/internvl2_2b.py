"""internvl2-2b [vlm] — InternViT + InternLM2 backbone (arXiv:2404.16821).

LM backbone: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
Vision frontend is a STUB: the data pipeline and the serve CLI provide random patch
embeddings (b, num_patches, d_model) prepended to the token sequence.
"""
from repro_torch.configs import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        mlp_act="swiglu",
        norm="rmsnorm",
        rope_theta=1000000.0,
        frontend="vision_patches",
        num_patches=256,
        attn_impl="ulysses",
    )

"""musicgen-medium [audio] — decoder-only over EnCodec tokens (arXiv:2306.05284).

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.
Modality frontend is a STUB: the data pipeline and the serve CLI provide random frame
embeddings (b, s, d_model) in place of EnCodec's; the transformer backbone is what is built.
24 heads % 16 != 0 -> all-gather context parallelism (FPDT-CP).
"""
from repro_torch.configs import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        mlp_act="gelu",
        norm="layernorm",
        frontend="audio_frames",
        attn_impl="cp",
    )

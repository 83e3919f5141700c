"""Model configs and the registry of ported architectures.

A copy of the JAX package's ``ModelConfig``/``ShapeConfig``/``get_config``/
``reduced`` (the port imports nothing from it).  The JAX package's 16
architectures are registered, its ten and the paper's models
(``PAPER_ARCHS``); ``get_config`` raises for any other name.  Some fit one
card only cut in depth or reduced (llama4-maverick-400b-a17b's 778 B
parameters, yi-34b's and mistral-nemo-12b's training state).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba1)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 = auto ceil(d_model/16)

    # hybrid (recurrentgemma): cycle of block kinds; window for local attn
    block_pattern: Tuple[str, ...] = ()
    window: int = 0

    # modality frontends
    frontend: str = "none"  # none | audio_frames | vision_patches
    num_patches: int = 0

    # numerics / structure
    mlp_act: str = "swiglu"  # swiglu | gelu
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"

    # --- the paper's technique + parallelism knobs -----------------------
    attn_impl: str = "auto"  # auto | ulysses | cp | none
    fpdt_chunks: int = 1  # u; 1 = un-chunked baseline
    fpdt_offload: bool = False  # offload idle KV chunks to host memory
    fpdt_unroll: bool = False
    mlp_chunks: int = 1  # paper: 2x attention chunks
    loss_chunks: int = 0  # 0 = auto: ceil(vocab/d_model) * 2 (paper 5.4)
    remat: str = "full"  # none | full | offload
    scan_layers: bool = True
    # block-sparse attention (paper §5.6 / Table 4): fraction of off-diagonal
    # chunk pairs skipped (0.0 = full attention); diagonal always kept
    attn_sparsity: float = 0.0
    # flash-attention kernel tiling
    block_q: int = 512
    block_k: int = 512

    # ----------------------------------------------------------------- api
    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def padded_vocab(self) -> int:
        """Embedding/head table rows padded to 128 (Megatron-style);
        labels/ids never touch padding."""
        return -(-self.vocab_size // 128) * 128

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def block_kind(self, layer: int) -> str:
        """Mixer kind of layer ``layer``: attn | ssm | rglru | local_attn."""
        if self.family == "ssm":
            return "ssm"
        if self.block_pattern:
            return self.block_pattern[layer % len(self.block_pattern)]
        return "attn"

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.block_kind(i) for i in range(self.num_layers))

    def num_params(self) -> int:
        """Total parameter count (embedding included once if tied)."""
        return _count_params(self)

    def num_active_params(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        return _count_params(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


def _count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    d, dff = cfg.d_model, cfg.d_ff
    n_mlp_mats = 3 if cfg.mlp_act == "swiglu" else 2
    total = 0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "local_attn"):
            total += d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
            if cfg.qkv_bias:
                total += cfg.q_dim + 2 * cfg.kv_dim
        elif kind == "ssm":
            di, ds, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_actual
            total += d * 2 * di  # in_proj
            total += di * cfg.d_conv + di  # depthwise conv + bias
            total += di * (dtr + 2 * ds)  # x_proj
            total += dtr * di + di  # dt_proj
            total += di * ds + di  # A_log, D
            total += di * d  # out_proj
        elif kind == "rglru":
            di = cfg.d_inner if cfg.expand else d
            total += 2 * d * di  # x and gate branches
            total += di * cfg.d_conv + di  # temporal conv
            total += 2 * di  # RG-LRU a-param + input gate proj (diag)
            total += 2 * di * di  # recurrent/input gate dense (lru)
            total += di * d  # out proj
        if kind == "ssm":
            continue  # mamba block has no separate MLP
        if cfg.num_experts:
            e = cfg.experts_per_token if active_only else cfg.num_experts
            total += e * n_mlp_mats * d * dff
            total += d * cfg.num_experts  # router
        else:
            total += n_mlp_mats * d * dff
        total += 2 * d  # norms
    total += cfg.vocab_size * d  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d  # lm head
    total += d  # final norm
    return total


# --------------------------------------------------------------------------
# Registry: the JAX package's architectures
# --------------------------------------------------------------------------

PAPER_ARCHS = (
    "gpt-2.7b",
    "gpt-6.7b",
    "gpt-13b",
    "gpt-30b",
    "llama-8b",
    "llama-70b",
)

_MODULE_FOR = {
    "llama3.2-1b": "llama3p2_1b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "musicgen-medium": "musicgen_medium",
    "yi-34b": "yi_34b",
    "qwen1.5-4b": "qwen1p5_4b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "internvl2-2b": "internvl2_2b",
    "gpt-2.7b": "gpt_paper",
    "gpt-6.7b": "gpt_paper",
    "gpt-13b": "gpt_paper",
    "gpt-30b": "gpt_paper",
    "llama-8b": "llama_paper",
    "llama-70b": "llama_paper",
}


def list_configs():
    return sorted(_MODULE_FOR)


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in _MODULE_FOR:
        raise KeyError(f"unknown arch {name!r}; known: {list_configs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[name]}")
    cfg = mod.config(name) if name in PAPER_ARCHS else mod.config()
    if overrides:
        cfg = replace(cfg, **overrides)
    return cfg


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    kwargs = dict(
        name=cfg.name + "-reduced",
        num_layers=min(cfg.num_layers, 3 if not cfg.block_pattern else len(cfg.block_pattern)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128 if not cfg.num_experts else 32,
        vocab_size=256,
        num_patches=min(cfg.num_patches, 4),
        block_q=16,
        block_k=16,
    )
    if cfg.num_experts:
        kwargs["num_experts"] = min(cfg.num_experts, 4)
        kwargs["experts_per_token"] = min(cfg.experts_per_token, 2)
    if cfg.family == "ssm" or "ssm" in cfg.block_pattern or "rglru" in cfg.block_pattern:
        kwargs["expand"] = 2
        kwargs["ssm_state"] = min(cfg.ssm_state or 4, 4)
        kwargs["dt_rank"] = 4
    if cfg.window:
        kwargs["window"] = 8
    return replace(cfg, **kwargs)

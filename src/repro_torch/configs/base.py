"""Configuration system.

``ModelConfig`` is the single architecture description shared by every family
(dense / moe / ssm / hybrid / encdec / vlm).  ``ShapeConfig`` describes an
assigned input-shape cell.  Architectures register themselves with
``register_arch`` from ``repro_torch.configs.<id>`` modules; ``get_arch(name)``
resolves ``--arch`` flags.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional

from repro_torch.utils import round_up

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

VOCAB_PAD_MULTIPLE = 2048  # Megatron-style vocab padding for clean TP sharding


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_ff: int = 0                  # per-expert hidden size
    dense_residual: bool = False   # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    every: int = 1                 # MoE layer stride (jamba: every 2nd layer)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    chunk: int = 256               # SSD chunk length for the blocked scan
    n_groups: int = 1              # B/C groups (Mamba2 default 1)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | gelu
    use_bias: bool = False
    parallel_block: bool = False   # command-r style parallel attn+ffn residual
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): attention at layer i % attn_every == attn_offset
    attn_every: int = 0
    attn_offset: int = 0
    # vlm: cross-attention at layer i % cross_attn_every == cross_attn_every-1
    cross_attn_every: int = 0
    num_vision_tokens: int = 0
    # encdec (whisper)
    enc_layers: int = 0
    num_audio_frames: int = 0
    # numerics / memory policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"       # adamw | adafactor (big archs)
    remat: bool = True
    # perf knobs (hillclimb levers; defaults are the paper-faithful baseline)
    attn_impl: str = "naive"       # naive | blocked
    attn_block_q: int = 512
    attn_mixed: bool = False       # bf16 operands + fp32 accumulation
    moe_sharded_dispatch: bool = False  # sharding hints on the MoE buffers
    xent_impl: str = "full"        # full | chunked
    xent_chunk: int = 8192
    sharding_profile: str = "dp_tp"  # dp_tp | fsdp_tp
    # Dry-run cost-exactness: XLA's cost_analysis does not multiply while-loop
    # trip counts, so the dry-run fully unrolls the structural scans (HLO gets
    # big; costs get exact).  Runtime paths keep the rolled scans.
    unroll_blocks: bool = False
    notes: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, VOCAB_PAD_MULTIPLE)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode path (SSM/hybrid): eligible for long_500k."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def layer_kind(self, i: int) -> str:
        """'attn' | 'mamba' for the token-mixing sublayer of layer i."""
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid":
            return "attn" if i % self.attn_every == self.attn_offset else "mamba"
        return "attn"

    def layer_has_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        return i % self.moe.every == (self.moe.every - 1)

    def layer_has_cross_attn(self, i: int) -> bool:
        if self.family != "vlm" or self.cross_attn_every <= 0:
            return False
        return i % self.cross_attn_every == self.cross_attn_every - 1

    # Parameter count (for 6ND model-flops accounting) ------------------
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.num_layers
        hd = self.head_dim
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        total = emb
        for i in range(L):
            kind = self.layer_kind(i)
            if kind == "attn":
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                total += q + kv + o
            else:
                ssm = self.ssm
                di = ssm.d_inner(d)
                nh = ssm.n_heads(d)
                in_proj = d * (2 * di + 2 * ssm.n_groups * ssm.d_state + nh)
                conv = (di + 2 * ssm.n_groups * ssm.d_state) * ssm.conv_kernel
                out = di * d
                total += in_proj + conv + out + nh  # +A_log/D per head
            if self.layer_has_moe(i):
                m = self.moe
                ff = m.num_experts * 3 * d * m.d_ff
                router = d * m.num_experts
                total += ff + router
                if m.dense_residual:
                    total += 3 * d * self.d_ff
                if active_only:
                    total -= (m.num_experts - m.top_k) * 3 * d * m.d_ff
            else:
                n_mats = 3 if self.act == "swiglu" else 2
                total += n_mats * d * self.d_ff
            if self.layer_has_cross_attn(i):
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                total += q + kv + o
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder already counted above
            enc = self.enc_layers * (
                (2 * d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd)
                + (3 if self.act == "swiglu" else 2) * d * self.d_ff
            )
            # decoder cross-attn per layer
            dec_cross = L * (2 * d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd)
            total += enc + dec_cross
        return int(total)


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k only for sub-quadratic (SSM/hybrid) archs; decode shapes for
    archs with a decoder (all assigned archs have one)."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    if shape.kind == "decode":
        return cfg.has_decoder
    return True


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_ARCHS: dict[str, ModelConfig] = {}


def register_arch(cfg: ModelConfig) -> ModelConfig:
    _ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[name]


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_ARCHS)


def with_overrides(cfg: ModelConfig, **kw) -> ModelConfig:
    return replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------

def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving miniature of ``cfg`` for single-CPU smoke tests."""
    kw: dict = dict(
        num_layers=max(2, cfg.attn_every or 0, cfg.cross_attn_every or 0,
                       (cfg.moe.every if cfg.moe else 0)),
        d_model=64,
        num_heads=4,
        num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=257,   # deliberately non-multiple to exercise padding
        remat=False,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.family == "hybrid":
        kw["num_layers"] = 2 * cfg.attn_every  # two full interleave blocks
    if cfg.family == "vlm":
        kw["num_layers"] = 2 * cfg.cross_attn_every
        kw["num_vision_tokens"] = 8
    if cfg.family == "encdec":
        kw["enc_layers"] = 2
        kw["num_audio_frames"] = 12
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=4, top_k=2, d_ff=32,
            dense_residual=cfg.moe.dense_residual,
            capacity_factor=2.0, every=cfg.moe.every,
        )
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, expand=2, head_dim=16, conv_kernel=4,
                              chunk=8, n_groups=1)
    return dataclasses.replace(cfg, **kw)


__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
    "shape_applicable", "register_arch", "get_arch", "list_archs",
    "reduced", "with_overrides",
]

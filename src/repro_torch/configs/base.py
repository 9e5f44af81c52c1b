"""Config dataclasses: model architectures and input shapes.

Every assigned architecture gets one module in this package exposing
``CONFIG`` (the exact published dims) and ``smoke()`` (a reduced config of
the same family for CPU tests). Input shapes are global — each (arch x
shape) cell is defined by :func:`applicable`.

A copy of ``src/repro/configs/base.py``, including the parameters of the
modelled accelerator fleet (``FleetConfig`` / ``FLEET``) that the mesh
planner (``core.meshplan``) places jobs on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (applies to every layer)."""
    n_experts: int            # routed experts
    top_k: int
    n_shared_experts: int = 0  # always-on experts (qwen2-moe style)
    shared_d_ff: int = 0       # hidden dim of the shared expert(s)
    router_jitter: float = 0.0
    # capacity_factor is a serving/training lever, not an arch constant
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block config."""
    state_dim: int            # N — SSM state size per head
    head_dim: int = 64        # P — channels per SSM head
    expand: int = 2           # d_inner = expand * d_model
    conv_dim: int = 4         # depthwise conv kernel width
    chunk: int = 256          # SSD chunk length
    n_groups: int = 1         # B/C groups (GVA-style sharing)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str               # dense | moe | hybrid | ssm | vlm | enc_dec
    n_layers: int             # decoder layers (or total layers for hybrid/ssm)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                 # per-expert hidden for MoE
    vocab_size: int
    head_dim: Optional[int] = None   # None -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True            # False -> sinusoidal absolute (whisper)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0              # hybrid: attn block each k layers (shared weights)
    n_enc_layers: int = 0            # enc-dec only
    n_vis_tokens: int = 0            # vlm: stubbed patch embeddings prepended
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.head_dim

    # ---- hybrid layer layout ------------------------------------------------
    def layer_kinds(self) -> list[str]:
        """Per-layer kind list: 'attn' | 'mamba' | 'moe' | 'dense'."""
        if self.family == "ssm":
            return ["mamba"] * self.n_layers
        if self.family == "hybrid":
            k = self.attn_every
            return ["attn" if (i % k == k - 1) else "mamba"
                    for i in range(self.n_layers)]
        if self.family == "moe":
            return ["moe"] * self.n_layers
        return ["dense"] * self.n_layers

    def n_attn_layers(self) -> int:
        return sum(1 for k in self.layer_kinds() if k == "attn")

    # ---- parameter counting (for 6ND roofline) -------------------------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (matches init to within tying details)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        dense_mlp = 3 * d * self.d_ff  # SwiGLU: gate+up+down
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        per_layer_norms = 2 * d
        total = embed + head + d  # final norm
        if self.family == "enc_dec":
            enc_layer = attn + dense_mlp + per_layer_norms
            dec_layer = attn + attn + dense_mlp + 3 * d  # self+cross
            return total + self.n_enc_layers * enc_layer + self.n_layers * dec_layer
        kinds = self.layer_kinds()
        for kind in kinds:
            if kind == "dense":
                total += attn + dense_mlp + per_layer_norms
            elif kind == "moe":
                m = self.moe
                experts = m.n_experts * 3 * d * self.d_ff
                shared = m.n_shared_experts * 3 * d * m.shared_d_ff
                router = d * m.n_experts
                if active_only:
                    experts = m.top_k * 3 * d * self.d_ff
                total += attn + experts + shared + router + per_layer_norms
            elif kind == "mamba":
                s = self.ssm
                di = self.d_inner
                nh = self.n_ssm_heads
                # in_proj produces (z, x, B, C, dt): 2*di + 2*groups*N + nh
                in_proj = d * (2 * di + 2 * s.n_groups * s.state_dim + nh)
                conv = s.conv_dim * (di + 2 * s.n_groups * s.state_dim)
                out_proj = di * d
                total += in_proj + conv + out_proj + nh * 2 + d  # A,D, norm
            elif kind == "attn":
                total += attn + dense_mlp + per_layer_norms
        if self.family == "hybrid" and self.attn_every:
            # shared attention block: weights counted once, not per occurrence
            n_attn = self.n_attn_layers()
            if n_attn > 1:
                total -= (n_attn - 1) * (attn + dense_mlp + per_layer_norms)
        return int(total)


# ---------------------------------------------------------------------------
# Input shapes (assigned, global)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int       # train/prefill: tokens per sequence; decode: KV cache length
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# long-context decode needs a sub-quadratic sequence path; only SSM/hybrid
# archs qualify (the 8 pure full-attention archs SKIP long_500k — DESIGN.md
# §Arch-applicability). No assigned arch is encoder-only, so decode shapes
# run everywhere else.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


# ---------------------------------------------------------------------------
# Parameters of the modelled fleet (core.meshplan)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The accelerator fleet the mesh planner maps jobs onto.

    These are inputs of the placement model, kept equal to the reference's
    field for field so both packages build the same topology; they describe
    the modelled fleet, not the device this package computes on.
    ``peak_flops_bf16``, ``hbm_bw`` and ``hbm_bytes`` feed the reference's
    roofline bench only; nothing in this package reads them.
    """
    chips_per_pod: int = 256
    chips_per_host: int = 8
    peak_flops_bf16: float = 197e12     # FLOP/s per chip (roofline input)
    hbm_bw: float = 819e9               # bytes/s per chip (roofline input)
    hbm_bytes: float = 16e9             # bytes per chip (roofline input)
    ici_bw_per_link: float = 50e9       # bytes/s per intra-pod link
    ici_links_per_chip: int = 4         # intra-pod links per chip
    dcn_bw_per_host: float = 25e9       # bytes/s of each host's pod-boundary NIC

    @property
    def hosts_per_pod(self) -> int:
        return self.chips_per_pod // self.chips_per_host


FLEET = FleetConfig()

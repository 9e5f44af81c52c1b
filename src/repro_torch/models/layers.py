"""Shared transformer layers (dense subset): RMSNorm, RoPE, GQA attention,
SwiGLU, the pre-norm dense block.

The port of ``src/repro/models/layers.py`` as ``nn.Module``s. Weights keep
the reference's layout (``x @ W`` with ``W (in, out)``) and names, so
``repro_torch.models.convert`` carries the reference's parameters across
one for one. Attention and RMSNorm go through
:mod:`repro_torch.kernels.ops`: the hand-written kernels for CUDA tensors,
the plain versions for CPU tensors or ``impl="plain"``. The reference's
``parallel.shard`` constraints are the identity on one device and are not
ported. Serving only: parameters do not require grad.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs import ModelConfig
from ..kernels import ops


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------
def _param(shape, dtype, device, fill: Optional[float] = None) -> nn.Parameter:
    t = (torch.empty(shape, dtype=dtype, device=device) if fill is None
         else torch.full(shape, fill, dtype=dtype, device=device))
    return nn.Parameter(t, requires_grad=False)


def truncated_normal_(p: torch.Tensor, gen: torch.Generator, std: float) -> None:
    """``p <- N(0, 1) truncated to [-3, 3], times std``, drawn in float32 on
    p's device from ``gen`` (the reference's ``dense_init`` / ``embed_init``;
    the draws differ from JAX's, the distribution is the same)."""
    t = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-3.0, b=3.0, generator=gen)
    p.copy_(t * std)


def dense_init_(p: torch.Tensor, gen: torch.Generator) -> None:
    truncated_normal_(p, gen, p.shape[0] ** -0.5)


# ---------------------------------------------------------------------------
# Norms / positions
# ---------------------------------------------------------------------------
class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype, device, impl: Optional[str] = None):
        super().__init__()
        self.scale = _param((d,), dtype, device, fill=1.0)
        self.eps = eps
        self.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.rmsnorm(x, self.scale, self.eps, impl=self.impl)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with positions (S,) or (B, S). Computed in float32,
    cast back to x's dtype (the reference's promotion order)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freq  # (B,S,half)
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (full-sequence + decode)
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """GQA self-attention with optional qk-norm and RoPE."""

    def __init__(self, cfg: ModelConfig, dtype, device, impl: Optional[str] = None):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        self.cfg, self.impl = cfg, impl
        self.wq = _param((d, qd), dtype, device)
        self.wk = _param((d, kvd), dtype, device)
        self.wv = _param((d, kvd), dtype, device)
        self.wo = _param((qd, d), dtype, device)
        if cfg.qk_norm:
            hd = cfg.resolved_head_dim
            self.q_norm = RMSNorm(hd, cfg.norm_eps, dtype, device, impl)
            self.k_norm = RMSNorm(hd, cfg.norm_eps, dtype, device, impl)

    def init(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, gen)

    def qkv(self, x: torch.Tensor, positions: Optional[torch.Tensor]):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        q = (x @ self.wq).reshape(b, s, cfg.n_heads, hd)
        k = (x @ self.wk).reshape(b, s, cfg.n_kv_heads, hd)
        v = (x @ self.wv).reshape(b, s, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        if cfg.use_rope and positions is not None:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, *, causal: bool = True, q_offset: int = 0):
        """Full-sequence attention. Returns (out, (k, v)) for cache building."""
        cfg = self.cfg
        b, s, _ = x.shape
        positions = q_offset + torch.arange(s, device=x.device)
        q, k, v = self.qkv(x, positions if cfg.use_rope else None)
        o = ops.attention(q, k, v, causal=causal, q_offset=q_offset, impl=self.impl)
        return o.reshape(b, s, cfg.q_dim) @ self.wo, (k, v)

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
        """One-token attention. x: (B, 1, d); caches: (B, S, KVH, hd), written
        IN PLACE at ``[b, pos[b]]`` (the reference's ``.at[].set``); pos: (B,)."""
        cfg = self.cfg
        b = x.shape[0]
        q, k_new, v_new = self.qkv(x, pos[:, None] if cfg.use_rope else None)
        bidx = torch.arange(b, device=x.device)
        cache_k[bidx, pos] = k_new[:, 0]
        cache_v[bidx, pos] = v_new[:, 0]
        o = ops.decode_attention(q, cache_k, cache_v, pos, impl=self.impl)
        return o.reshape(b, 1, cfg.q_dim) @ self.wo


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """SwiGLU: ``silu(x @ w_gate) * (x @ w_up) @ w_down``."""

    def __init__(self, cfg: ModelConfig, dtype, device, d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = _param((d, f), dtype, device)
        self.w_up = _param((d, f), dtype, device)
        self.w_down = _param((f, d), dtype, device)

    def init(self, gen: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.swiglu(x, self.w_gate, self.w_up, self.w_down)


# ---------------------------------------------------------------------------
# Dense transformer block (pre-norm residual)
# ---------------------------------------------------------------------------
class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, impl: Optional[str] = None):
        super().__init__()
        self.attn = Attention(cfg, dtype, device, impl)
        self.mlp = MLP(cfg, dtype, device)
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device, impl)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device, impl)

    def init(self, gen: torch.Generator) -> None:
        self.attn.init(gen)
        self.mlp.init(gen)

    def forward(self, x: torch.Tensor, *, causal: bool = True, q_offset: int = 0):
        h, kv = self.attn(self.ln1(x), causal=causal, q_offset=q_offset)
        x = x + h
        x = x + self.mlp(self.ln2(x))
        return x, kv

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
        x = x + self.attn.decode(self.ln1(x), cache_k, cache_v, pos)
        return x + self.mlp(self.ln2(x))

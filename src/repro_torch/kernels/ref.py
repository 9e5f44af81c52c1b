"""Plain PyTorch versions of the model zoo's kernels: the semantics of record.

A copy of ``src/repro/kernels/ref.py`` (dense-model part) in PyTorch. The
hand-written kernels (``flash_attention``, ``rmsnorm``) are held to these,
the CPU path runs them, and :mod:`repro_torch.kernels.ops` reaches them for
CPU tensors or with ``impl="plain"``. They run on any device.

Type rules follow the reference: attention scores are float32 whatever the
input type (the reference's ``preferred_element_type=float32``), the
probabilities are rounded to ``v``'s type before ``P·V``, which accumulates
in float32 and rounds once; RMSNorm takes its statistics in float32 and
casts to the input type *before* the multiply by ``scale``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


# ---------------------------------------------------------------------------
# Attention (GQA, causal / full, chunked over queries for long sequences)
# ---------------------------------------------------------------------------
def _attend_block(q, k, v, mask, scale):
    """GQA attention without materialising repeated k/v.

    q: (B, Lq, H, D); k, v: (B, Lk, KVH, D), H = KVH * rep. The grouped
    einsum reads each kv head once. mask: broadcastable (B,1,1,Lq,Lk).
    """
    b, lq, h, d = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, lq, kvh, rep, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs.float(), v.float())
    return out.to(v.dtype).reshape(b, lq, h, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0,
              q_chunk: int = 1024, chunk_threshold: int = 4096) -> torch.Tensor:
    """Multi-head attention with GQA.

    q: (B, Sq, H, D); k, v: (B, Skv, KVH, D), H % KVH == 0.
    ``q_offset`` — absolute position of q[0] (prefill continuation).
    Sequences longer than ``chunk_threshold`` go over query chunks so the
    (Sq, Skv) score matrix is never materialised whole.
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = d ** -0.5
    kpos = torch.arange(skv, device=q.device)[None, :]

    def mask_for(qpos):
        if not causal:
            return None
        return (qpos[:, None] >= kpos)[None, None, None]  # (1,1,1,Lq,Skv)

    if sq <= chunk_threshold:
        qpos = q_offset + torch.arange(sq, device=q.device)
        return _attend_block(q, k, v, mask_for(qpos), scale)

    n_chunks = sq // q_chunk
    assert sq % q_chunk == 0, f"seq {sq} not divisible by q_chunk {q_chunk}"
    outs = []
    for i in range(n_chunks):
        qpos = q_offset + i * q_chunk + torch.arange(q_chunk, device=q.device)
        outs.append(_attend_block(q[:, i * q_chunk:(i + 1) * q_chunk], k, v,
                                  mask_for(qpos), scale))
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a fixed-size KV cache.

    q: (B, 1, H, D); caches: (B, S, KVH, D); pos: (B,) int — index of the
    *current* token; cache entries at index > pos are masked out.
    """
    d = q.shape[-1]
    s = k_cache.shape[1]
    valid = torch.arange(s, device=q.device)[None, :] <= pos[:, None]
    return _attend_block(q, k_cache, v_cache,
                         valid[:, None, None, None, :], d ** -0.5)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` as the reference's ``jax.nn.silu`` lowers it:
    ``x * (1 / (1 + exp(-x)))`` with every step rounded to x's dtype.
    (``torch.nn.functional.silu`` rounds once, which differs in bfloat16.)"""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """x: (..., d); w_gate/w_up: (d, f); w_down: (f, d)."""
    h = silu(x @ w_gate) * (x @ w_up)
    return h @ w_down

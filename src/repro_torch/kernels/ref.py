"""Plain PyTorch versions of the model zoo's kernels: the semantics of record.

A copy of ``src/repro/kernels/ref.py`` in PyTorch. The hand-written
kernels (``flash_attention``, ``rmsnorm``, ``ssd_scan``) are held to these,
the CPU path runs them, and :mod:`repro_torch.kernels.ops` reaches them for
CPU tensors or with ``impl="plain"``. They run on any device.

Type rules follow the reference: attention scores are float32 whatever the
input type (the reference's ``preferred_element_type=float32``), the
probabilities are rounded to ``v``'s type before ``P·V``, which accumulates
in float32 and rounds once; RMSNorm takes its statistics in float32 and
casts to the input type *before* the multiply by ``scale``. The SSD scan
computes in float32 and rounds ``y_intra + y_inter + D·x`` to x's type
once; ``causal_conv1d`` rounds every product and partial sum to x's type
(a Python ``sum``), ``conv1d_step`` sums in float32 and rounds once (an
einsum) — so prefill and decode round differently, as in the reference.
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


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as the reference's ``jax.nn.softplus`` lowers it,
    ``logaddexp(x, 0)``. (``torch.nn.functional.softplus`` takes
    ``log1p(exp(x))`` below its threshold, which rounds otherwise for x > 0.)"""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality): chunked scan and one-token recurrence
# ---------------------------------------------------------------------------
def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, D: torch.Tensor, *, chunk: int = 256,
             initial_state: torch.Tensor | None = None):
    """Chunked SSD forward (Mamba2 sec. 6 block decomposition).

    x: (b, s, h, p); dt: (b, s, h) positive step sizes; A: (h,) negative
    decay; B, C: (b, s, g, n) with h % g == 0; D: (h,) skip;
    initial_state: (b, h, p, n) or None (zeros).
    Returns (y (b, s, h, p) in x's dtype, final_state (b, h, p, n) float32).

    The within-chunk ``cumsum(A·dt)`` is summed in float64 and rounded to
    float32 once (PyTorch's CPU cumsum of float32 does exactly that); the
    kernel does the same, so the two agree on the decays however
    ``torch.cumsum`` orders its sums on the card. At ``A·dt`` ≈ −11 a step
    the sums reach −2,800 inside a 256-chunk, where one float32 unit is
    2.4e-4 and a differently ordered float32 sum would move
    ``exp(cum_i − cum_j)`` by that much.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    nc, l = s // chunk, chunk
    rep = h // g
    f32 = torch.float32

    xc = x.reshape(b, nc, l, h, p).to(f32)
    dtc = dt.reshape(b, nc, l, h).to(f32)
    Bc = B.reshape(b, nc, l, g, n).repeat_interleave(rep, dim=3).to(f32)
    Cc = C.reshape(b, nc, l, g, n).repeat_interleave(rep, dim=3).to(f32)

    adt = A.to(f32) * dtc                                   # (b,nc,l,h) <= 0
    cum = torch.cumsum(adt, dim=2, dtype=torch.float64).to(f32)
    # intra-chunk: M[i,j] = C_i.B_j * exp(cum_i - cum_j) * dt_j  (j <= i);
    # exp is never taken where j > i (seg > 0 there could overflow)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,nc,i,j,h)
    iota = torch.arange(l, device=x.device)
    causal = (iota[:, None] >= iota[None, :])[None, None, :, :, None]
    seg = torch.where(causal, seg, 0.0)
    decay = torch.where(causal, torch.exp(seg), 0.0)
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc)
    M = scores * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xc)

    # per-chunk terminal states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtc         # (b,nc,l,h)
    Sc = torch.einsum("bclhn,bclhp->bchpn", tail[..., None] * Bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (b,nc,h)

    # inter-chunk recurrence: H_c = decay_c * H_{c-1} + S_c, emitting the
    # state *entering* each chunk
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    h_in = []
    for c in range(nc):
        h_in.append(state)
        state = state * chunk_decay[:, c, :, None, None] + Sc[:, c]
    h_in = torch.stack(h_in, dim=1)                         # (b,nc,h,p,n)

    # contribution of the incoming state: y_i += C_i . (exp(cum_i) * H_in)
    y_inter = torch.einsum("bclhn,bchpn->bclhp", Cc * torch.exp(cum)[..., None], h_in)

    y = y_intra + y_inter + D.to(f32)[None, None, None, :, None] * xc
    return y.reshape(b, s, h, p).to(x.dtype), state


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
                    A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor,
                    D: torch.Tensor):
    """One-token SSD recurrence.

    state: (b, h, p, n) float32; x_t: (b, h, p); dt_t: (b, h);
    B_t, C_t: (b, g, n). Returns (y_t (b, h, p) in x_t's dtype, new_state).
    """
    h = state.shape[1]
    rep = h // B_t.shape[1]
    f32 = torch.float32
    Bh = B_t.repeat_interleave(rep, dim=1).to(f32)          # (b,h,n)
    Ch = C_t.repeat_interleave(rep, dim=1).to(f32)
    dt = dt_t.to(f32)
    dec = torch.exp(A.to(f32)[None, :] * dt)                # (b,h)
    upd = (dt[:, :, None] * Bh)[:, :, None, :] * x_t.to(f32)[..., None]
    new_state = state * dec[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    y = y + D.to(f32)[None, :, None] * x_t.to(f32)
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (the Mamba block's front conv) + one-token update
# ---------------------------------------------------------------------------
def causal_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                  cache: torch.Tensor | None = None):
    """x: (b, s, c), w: (k, c) depthwise. Returns (y, new_cache (b, k-1, c)).
    Every product and partial sum is rounded to x's dtype (a Python ``sum``
    of k products, as the reference writes it)."""
    k = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return y, xp[:, xp.shape[1] - (k - 1):, :]


def conv1d_step(x_t: torch.Tensor, w: torch.Tensor, cache: torch.Tensor):
    """One-token conv. x_t: (b, c); cache: (b, k-1, c). The k products are
    summed in float32 and rounded to x's dtype once (the reference's einsum)."""
    window = torch.cat([cache, x_t[:, None, :]], dim=1)    # (b,k,c)
    y = torch.einsum("bkc,kc->bc", window.float(), w.to(x_t.dtype).float())
    return y.to(x_t.dtype), window[:, 1:, :]

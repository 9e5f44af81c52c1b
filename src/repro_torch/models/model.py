"""Model builder: ``build_model(cfg)`` -> :class:`Model` (dense) or
:class:`SSMModel` (ssm).

The port of the decoder-only LM (``_build_lm``, ``family == "dense"``) and
of the pure SSM LM (``_build_ssm``, mamba2) of ``src/repro/models/model.py``,
serving surface only:

  init(generator)                          random weights from a torch.Generator
  prefill(tokens) -> (last_logits, cache)  inference prefill
  decode_step(cache, tokens, pos)
      -> (logits, cache)                   one-token serve, cache written in place
  init_cache(batch_size, cache_len)        zeros cache

The weights live in the module (the reference passes a parameter tree;
``repro_torch.models.convert`` carries one across). The caches keep the
reference's layouts: dense ``{"k", "v": (n_layers, B, S, KVH, head_dim),
"pos": (B,) int32}``; ssm ``{"conv": (n_layers, B, conv_dim - 1, d_inner +
2 g n) in the model's dtype, "ssm": (n_layers, B, nh, head_dim, n) float32,
"pos"}``. Layers run in a Python loop where the reference scans over
stacked parameters.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs import ModelConfig
from ..core.simulator import resolve_device
from ..kernels import ops
from . import layers as L
from .ssm import MambaBlock

#: the families the port does not build yet, with the ROADMAP item that ports them
NOT_PORTED = {
    "hybrid": "ROADMAP queue 1, zamba2-7b (hybrid)",
    "moe": "ROADMAP queue 1, the rest of models/ (moe.py)",
    "vlm": "ROADMAP queue 1, the rest of models/ (vision tokens)",
    "enc_dec": "ROADMAP queue 1, the rest of models/ (encoder-decoder)",
}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class _LM(nn.Module):
    """What every family shares: the token embedding, the final norm and the
    head (tied to the embedding or its own)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 impl: Optional[str] = None):
        super().__init__()
        dt = _dtype(cfg)
        self.cfg, self.device, self.dtype, self.impl = cfg, device, dt, impl
        self.layers = nn.ModuleList(self._block(cfg, dt, device, impl)
                                    for _ in range(cfg.n_layers))
        self.embed = L._param((cfg.vocab_size, cfg.d_model), dt, device)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device, impl)
        if not cfg.tie_embeddings:
            self.head = L._param((cfg.d_model, cfg.vocab_size), dt, device)

    @torch.no_grad()
    def init(self, gen: torch.Generator):
        """Random weights (the reference's init distributions; norms = 1),
        drawn from ``gen``, a ``torch.Generator`` on the model's device."""
        for block in self.layers:
            block.init(gen)
        L.truncated_normal_(self.embed, gen, 1.0)
        if not self.cfg.tie_embeddings:
            L.dense_init_(self.head, gen)
        return self

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x.contiguous())
        w = self.embed.t() if self.cfg.tie_embeddings else self.head
        return x @ w.to(x.dtype)


class Model(_LM):
    """Dense decoder LM (pre-norm GQA blocks, SwiGLU, optional tied head)."""

    _block = L.DenseBlock

    @torch.no_grad()
    def prefill(self, tokens):
        """``tokens (B, S)`` -> ``(logits (B, vocab) of the last position,
        cache with S positions)``."""
        x = self.embed[self._tokens(tokens)]
        b, s = x.shape[0], x.shape[1]
        ks, vs = [], []
        for block in self.layers:
            x, (k, v) = block(x, causal=True)
            ks.append(k)
            vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "pos": torch.full((b,), s - 1, dtype=torch.int32, device=self.device)}
        return self._logits(x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, pos):
        """``tokens (B, 1)`` at positions ``pos (B,)`` -> ``(logits (B, vocab),
        cache)``. Writes each row's k / v into ``cache`` at ``[layer, b,
        pos[b]]`` in place; the returned cache holds the same tensors."""
        x = self.embed[self._tokens(tokens)]
        pos = torch.as_tensor(pos, device=self.device).to(torch.int32)
        for i, block in enumerate(self.layers):
            x = block.decode(x, cache["k"][i], cache["v"][i], pos)
        return self._logits(x[:, -1]), {"k": cache["k"], "v": cache["v"], "pos": pos}

    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        cfg = self.cfg
        shp = (cfg.n_layers, batch_size, cache_len, cfg.n_kv_heads,
               cfg.resolved_head_dim)
        return {"k": torch.zeros(shp, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shp, dtype=self.dtype, device=self.device),
                "pos": torch.zeros((batch_size,), dtype=torch.int32, device=self.device)}


class SSMModel(_LM):
    """Pure Mamba2 LM (``_build_ssm``): Mamba blocks, no MLP, tied head."""

    _block = MambaBlock

    @torch.no_grad()
    def prefill(self, tokens):
        """``tokens (B, S)`` -> ``(logits (B, vocab) of the last position,
        cache holding each layer's conv window and SSM state after S tokens)``."""
        x = self.embed[self._tokens(tokens)]
        b, s = x.shape[0], x.shape[1]
        convs, ssms = [], []
        for block in self.layers:
            x, (conv, ssm) = block(x, return_state=True)
            convs.append(conv)
            ssms.append(ssm)
        cache = {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
                 "pos": torch.full((b,), s - 1, dtype=torch.int32, device=self.device)}
        return self._logits(x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens, pos):
        """``tokens (B, 1)`` -> ``(logits (B, vocab), cache)``: advances every
        row's conv window and SSM state by one token, in place (``pos`` is
        carried, not read: the recurrence has no positions). Every row
        advances, whatever its ``pos``."""
        x = self.embed[self._tokens(tokens)]
        pos = torch.as_tensor(pos, device=self.device).to(torch.int32)
        for i, block in enumerate(self.layers):
            x = block.decode(x, cache["conv"][i], cache["ssm"][i])
        return (self._logits(x[:, -1]),
                {"conv": cache["conv"], "ssm": cache["ssm"], "pos": pos})

    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        """Zeros; ``cache_len`` is not needed (the state has a fixed size)."""
        cfg, s = self.cfg, self.cfg.ssm
        conv_c = cfg.d_inner + 2 * s.n_groups * s.state_dim
        return {
            "conv": torch.zeros((cfg.n_layers, batch_size, s.conv_dim - 1, conv_c),
                                dtype=self.dtype, device=self.device),
            "ssm": torch.zeros((cfg.n_layers, batch_size, cfg.n_ssm_heads,
                                s.head_dim, s.state_dim), dtype=torch.float32,
                               device=self.device),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=self.device)}


_BUILDERS = {"dense": Model, "ssm": SSMModel}


def build_model(cfg: ModelConfig, device=None, impl: Optional[str] = None):
    """The model of ``cfg`` on ``device`` (``None`` = the CUDA card, which
    raises where there is none): a :class:`Model` for ``family == "dense"``,
    an :class:`SSMModel` for ``"ssm"``. ``impl="plain"`` builds the twin that
    runs the plain versions of the kernels on any device."""
    if cfg.family not in _BUILDERS:
        if cfg.family in NOT_PORTED:
            raise NotImplementedError(f"family {cfg.family!r} ({cfg.arch_id}) is not "
                                      f"ported yet: {NOT_PORTED[cfg.family]}")
        raise ValueError(f"unknown family {cfg.family!r}")
    if impl not in ops.IMPLS:
        raise ValueError(f"impl must be one of {ops.IMPLS}, got {impl!r}")
    return _BUILDERS[cfg.family](cfg, resolve_device(device), impl)

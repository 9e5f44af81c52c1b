"""Model builder (dense family): ``build_model(cfg)`` -> :class:`Model`.

The port of the decoder-only LM of ``src/repro/models/model.py``
(``_build_lm``) for ``family == "dense"``, serving surface only:

  init(generator)                          random weights from a torch.Generator
  prefill(tokens) -> (last_logits, cache)  inference prefill
  decode_step(cache, tokens, pos)
      -> (logits, cache)                   one-token serve, cache written in place
  init_cache(batch_size, cache_len)        zeros cache

The weights live in the module (the reference passes a parameter tree;
``repro_torch.models.convert`` carries one across). The cache keeps the
reference's layout: ``{"k", "v": (n_layers, B, S, KVH, head_dim), "pos":
(B,) int32}``. Layers run in a Python loop where the reference scans over
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

#: the families the port does not build yet, with the ROADMAP item that ports them
NOT_PORTED = {
    "ssm": "ROADMAP queue 1, the SSM slice (models/ssm.py + the ssd_scan kernel)",
    "hybrid": "ROADMAP queue 1, the SSM slice (models/ssm.py + the ssd_scan kernel)",
    "moe": "ROADMAP queue 1, the rest of models/ (moe.py)",
    "vlm": "ROADMAP queue 1, the rest of models/ (vision tokens)",
    "enc_dec": "ROADMAP queue 1, the rest of models/ (encoder-decoder)",
}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Model(nn.Module):
    """Dense decoder LM (pre-norm GQA blocks, SwiGLU, optional tied head)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 impl: Optional[str] = None):
        super().__init__()
        dt = _dtype(cfg)
        self.cfg, self.device, self.dtype, self.impl = cfg, device, dt, impl
        self.layers = nn.ModuleList(L.DenseBlock(cfg, dt, device, impl)
                                    for _ in range(cfg.n_layers))
        self.embed = L._param((cfg.vocab_size, cfg.d_model), dt, device)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device, impl)
        if not cfg.tie_embeddings:
            self.head = L._param((cfg.d_model, cfg.vocab_size), dt, device)

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "Model":
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


def build_model(cfg: ModelConfig, device=None, impl: Optional[str] = None) -> Model:
    """The model of ``cfg`` on ``device`` (``None`` = the CUDA card, which
    raises where there is none). ``impl="plain"`` builds the twin that runs
    the plain versions of the kernels on any device."""
    if cfg.family != "dense":
        if cfg.family in NOT_PORTED:
            raise NotImplementedError(f"family {cfg.family!r} ({cfg.arch_id}) is not "
                                      f"ported yet: {NOT_PORTED[cfg.family]}")
        raise ValueError(f"unknown family {cfg.family!r}")
    if impl not in ops.IMPLS:
        raise ValueError(f"impl must be one of {ops.IMPLS}, got {impl!r}")
    return Model(cfg, resolve_device(device), impl)

"""Mamba2 block: projections + causal conv + gated SSD scan.

The port of ``src/repro/models/ssm.py`` as an ``nn.Module``. Prefill
(``forward``) runs the chunked SSD scan through ``ops.ssd_scan`` — the
hand-written kernel for CUDA tensors — and decode the O(1) recurrence with
the conv / SSM caches written in place. The block follows arXiv:2405.21060:
x / z / B / C / dt projections, a depthwise conv over the (x, B, C)
streams, a per-head scalar decay A, a gated RMSNorm before the
out-projection. Weights keep the reference's names and layouts, so
``repro_torch.models.convert`` carries them across one for one;
``A_log``, ``D`` and ``dt_bias`` are float32, the rest the model's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..configs import ModelConfig
from ..kernels import ops, ref
from . import layers as L


class MambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, impl: Optional[str] = None):
        super().__init__()
        s = cfg.ssm
        d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads
        gn = s.n_groups * s.state_dim
        self.cfg, self.impl = cfg, impl
        self.wz = L._param((d, di), dtype, device)
        self.wx = L._param((d, di), dtype, device)
        self.wB = L._param((d, gn), dtype, device)
        self.wC = L._param((d, gn), dtype, device)
        self.wdt = L._param((d, nh), dtype, device)
        self.dt_bias = L._param((nh,), torch.float32, device, fill=0.0)
        self.A_log = L._param((nh,), torch.float32, device)
        self.D = L._param((nh,), torch.float32, device, fill=1.0)
        self.conv_w = L._param((s.conv_dim, di + 2 * gn), dtype, device)
        self.norm = L.RMSNorm(di, cfg.norm_eps, dtype, device, impl)
        self.ln1 = L.RMSNorm(d, cfg.norm_eps, dtype, device, impl)
        self.out_proj = L._param((di, d), dtype, device)

    def init(self, gen: torch.Generator) -> None:
        """The reference's ``mamba_init`` distributions (``conv_w`` with
        ``in_axis=0``: fan-in = the conv width); ``A_log = log(linspace(1,
        16, nh))``, ``D = 1``, ``dt_bias = 0``, norms = 1."""
        for w in (self.wz, self.wx, self.wB, self.wC, self.wdt, self.conv_w,
                  self.out_proj):
            L.dense_init_(w, gen)
        nh = self.A_log.shape[0]
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                                  device=self.A_log.device)))
        self.D.fill_(1.0)
        self.dt_bias.fill_(0.0)
        self.norm.scale.fill_(1.0)
        self.ln1.scale.fill_(1.0)

    def _project(self, x: torch.Tensor):
        dt = ref.softplus((x @ self.wdt).float() + self.dt_bias)
        return x @ self.wz, x @ self.wx, x @ self.wB, x @ self.wC, dt

    def _split(self, conv: torch.Tensor):
        """silu(conv) cut into the x, B, C streams."""
        s = self.cfg.ssm
        di, gn = self.cfg.d_inner, s.n_groups * s.state_dim
        conv = ref.silu(conv)
        return conv[..., :di], conv[..., di:di + gn], conv[..., di + gn:]

    def forward(self, x: torch.Tensor, *, return_state: bool = False):
        """x: (B, S, d) -> (out, (conv_cache, ssm_state) if return_state else None)."""
        cfg, s = self.cfg, self.cfg.ssm
        b, sl, _ = x.shape
        nh = cfg.n_ssm_heads
        z, xin, Bc, Cc, dt = self._project(self.ln1(x))
        conv, conv_cache = ops.causal_conv1d(torch.cat([xin, Bc, Cc], dim=-1),
                                             self.conv_w)
        xin, Bc, Cc = self._split(conv)
        xh = xin.reshape(b, sl, nh, s.head_dim)
        Bh = Bc.reshape(b, sl, s.n_groups, s.state_dim)
        Ch = Cc.reshape(b, sl, s.n_groups, s.state_dim)
        A = -torch.exp(self.A_log)
        # pad to a chunk multiple; padded steps are identity updates (dt = 0
        # -> decay exp(0) = 1, input contribution 0), so y[:sl] and the final
        # state are exact
        pad = (-sl) % s.chunk
        if pad:
            xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
            Bh = F.pad(Bh, (0, 0, 0, 0, 0, pad))
            Ch = F.pad(Ch, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
        y, state = ops.ssd_scan(xh.contiguous(), dt.contiguous(), A, Bh.contiguous(),
                                Ch.contiguous(), self.D, chunk=s.chunk, impl=self.impl)
        if pad:
            y = y[:, :sl]
        y = y.reshape(b, sl, cfg.d_inner) * ref.silu(z)
        out = x + self.norm(y) @ self.out_proj
        return out, ((conv_cache, state) if return_state else None)

    def decode(self, x: torch.Tensor, conv_cache: torch.Tensor,
               ssm_state: torch.Tensor) -> torch.Tensor:
        """One token. x: (B, 1, d); conv_cache (B, k-1, c) and ssm_state
        (B, nh, p, n) are written IN PLACE (the reference returns new ones)."""
        cfg, s = self.cfg, self.cfg.ssm
        b = x.shape[0]
        z, xin, Bc, Cc, dt = self._project(self.ln1(x[:, 0]))
        conv, new_conv = ops.conv1d_step(torch.cat([xin, Bc, Cc], dim=-1),
                                         self.conv_w, conv_cache)
        conv_cache.copy_(new_conv)
        xin, Bc, Cc = self._split(conv)
        y, new_state = ops.ssd_decode_step(
            ssm_state, xin.reshape(b, cfg.n_ssm_heads, s.head_dim), dt,
            -torch.exp(self.A_log), Bc.reshape(b, s.n_groups, s.state_dim),
            Cc.reshape(b, s.n_groups, s.state_dim), self.D)
        ssm_state.copy_(new_state)
        y = y.reshape(b, cfg.d_inner) * ref.silu(z)
        return x + (self.norm(y) @ self.out_proj)[:, None, :]

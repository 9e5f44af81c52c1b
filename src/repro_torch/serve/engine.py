"""Batched serving engine: slot-based continuous batching.

The port of ``src/repro/serve/engine.py``. A fixed pool of ``batch`` slots
shares one cache (KV for a dense model, conv window + SSM state for
mamba2). Requests are admitted into free slots (their prompt runs token by
token through ``decode_step`` into the shared cache), every engine tick
runs ONE decode step for all slots, finished slots are recycled. The step
never changes shape; admission just rewrites cache rows — which resets
nothing: a recycled slot's SSM state starts from what its last request
left, as in the reference.

Sampling: greedy (argmax on the host, first index on ties) or temperature
(per request, from a ``torch.Generator`` seeded with ``seed``; its draws
are not JAX's, so only greedy output is held to the reference). The engine
is model-agnostic — it only uses the Model decode surface.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..models import Model, SSMModel


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0        # 0 -> greedy
    eos_id: Optional[int] = None
    # filled by the engine
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model: Model | SSMModel, batch: int, cache_len: int, seed: int = 0):
        self.model = model
        self.batch = batch
        self.cache_len = cache_len
        self.cache = model.init_cache(batch, cache_len)
        self.slots: list[Optional[Request]] = [None] * batch
        self.pos = np.zeros(batch, np.int32)
        self.cur_tok = np.zeros(batch, np.int32)
        self.remaining = np.zeros(batch, np.int32)
        self.gen = torch.Generator()
        self.gen.manual_seed(seed)
        # deque: admission drains the head every tick — popleft is O(1)
        self._queue: deque[Request] = deque()
        self.ticks = 0

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.batch):
            if self.slots[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            self._prefill_into_slot(slot, req)

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        """Run the prompt through decode steps into this slot's cache row
        (single-token stepping, as the reference does; ``Model.prefill`` is
        the bucketed alternative the cache layout already supports)."""
        prompt = np.asarray(req.prompt, np.int32)
        tok = prompt[0]
        pos = 0
        for t in range(1, len(prompt) + 1):
            logits = self._step_one(slot, tok, pos)
            tok = prompt[t] if t < len(prompt) else self._sample(logits, req)
            pos = t
        self.slots[slot] = req
        self.pos[slot] = pos
        self.cur_tok[slot] = tok
        self.remaining[slot] = req.max_new_tokens - 1
        req.output.append(int(tok))

    def _step_one(self, slot: int, tok: int, pos: int) -> np.ndarray:
        # every other slot re-decodes its pending token at its pos. For a KV
        # cache that write is idempotent; for an SSM state (mamba2) it is not:
        # the other slots' conv windows and states advance once more per
        # admitted prompt token. The reference's engine does the same, and the
        # port keeps it (ROADMAP queue 3)
        toks = self.cur_tok.copy()
        toks[slot] = int(tok)
        posv = self.pos.copy()
        posv[slot] = pos
        logits, self.cache = self.model.decode_step(self.cache, toks[:, None], posv)
        return logits[slot].float().cpu().numpy()

    def _sample(self, logits: np.ndarray, req: Request) -> int:
        if req.temperature <= 0:
            return int(np.argmax(logits))
        probs = torch.softmax(torch.from_numpy(logits).double() / req.temperature, -1)
        return int(torch.multinomial(probs, 1, generator=self.gen))

    # -- main loop -------------------------------------------------------------
    def tick(self) -> int:
        """One decode step for all active slots; returns #active."""
        self._admit()
        active = [s for s, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        self.ticks += 1
        # self.pos[s] is the NEXT write position (prefill wrote the prompt
        # at 0..pos-1 and left the sampled token pending) — decode the
        # pending token AT pos
        logits, self.cache = self.model.decode_step(
            self.cache, self.cur_tok[:, None], self.pos.copy())
        logits = logits.float().cpu().numpy()
        for s in active:
            req = self.slots[s]
            tok = self._sample(logits[s], req)
            req.output.append(tok)
            self.pos[s] += 1
            self.cur_tok[s] = tok
            self.remaining[s] -= 1
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if self.remaining[s] <= 0 or hit_eos or \
                    self.pos[s] >= self.cache_len - 1:
                req.done = True
                self.slots[s] = None
        return len(active)

    def run(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self._queue and all(s is None for s in self.slots):
                break
            self.tick()

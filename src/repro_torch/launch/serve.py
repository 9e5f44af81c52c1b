"""Serving entry point: batched continuous-batching engine over a model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --requests 16 --batch 8 --cache-len 2048 --max-new-tokens 32

runs on the CUDA card (``--device cuda``, the default; it raises without
one); ``--arch mamba2-370m`` serves the SSM model the same way.
``--smoke --device cpu`` serves the reduced config on the host.
Weights are random, drawn from a ``torch.Generator`` seeded with 0;
loading a checkpoint (the reference's ``--ckpt-dir``) waits for the port
of ``ckpt/``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..models import build_model
from ..serve import Request, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))

    eng = ServeEngine(model, batch=args.batch, cache_len=args.cache_len)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(2, 12))
        reqs.append(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, plen),
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature))
        eng.submit(reqs[-1])

    t0 = time.time()
    eng.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    toks = sum(len(r.output) for r in reqs)
    assert all(r.done for r in reqs)
    print(f"served {len(reqs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, {eng.ticks} engine ticks, "
          f"batch occupancy {toks/max(eng.ticks,1)/args.batch:.2f}) "
          f"on {model.device}")
    print("sample output:", reqs[0].output)


if __name__ == "__main__":
    main()

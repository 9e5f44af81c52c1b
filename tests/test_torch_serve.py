"""The port's serving engine against the reference's, on the CPU.

qwen3's and mamba2's smoke configs with the reference's weights carried
across: the port's ``ServeEngine`` must give the reference ``ServeEngine``'s
greedy tokens, token for token (float32 logits; argmax, first index on
ties), and for mamba2 the same conv / SSM caches (float32, 1e-5 of the
largest magnitude, the rule of ``tests/test_torch_ssm.py``). The engine
admits a prompt token by token through ``decode_step`` for every slot,
which for an SSM state is not idempotent: two tests pin that behaviour,
the same in both packages (ROADMAP queue 3). Temperature sampling draws
from a ``torch.Generator`` and is held only to its own seed. The
command-line entry point runs in a subprocess.
"""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model as ref_build_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model, convert
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    ref_model = ref_build_model(ref_smoke_config("qwen3-0.6b"))
    params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke_config("qwen3-0.6b"), device="cpu")
    convert.load_reference(model, jax.tree.map(np.asarray, params))
    return ref_model, params, model


@pytest.fixture(scope="module")
def ssm_pair():
    ref_model = ref_build_model(ref_smoke_config("mamba2-370m"))
    params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke_config("mamba2-370m"), device="cpu")
    convert.load_reference(model, jax.tree.map(np.asarray, params))
    return ref_model, params, model


def _engines(pair, batch, cache_len):
    """The reference's engine and the port's, each with its Request class."""
    ref_model, params, model = pair
    return ((RefServeEngine(ref_model, params, batch=batch, cache_len=cache_len), RefRequest),
            (ServeEngine(model, batch=batch, cache_len=cache_len), Request))


def _ssm_state(engine, slot) -> np.ndarray:
    """A copy of one slot's SSM state across the layers, as float32 numpy
    (the port's engine writes its cache in place)."""
    st = engine.cache["ssm"][:, slot]
    return st.numpy().copy() if isinstance(st, torch.Tensor) else np.array(st, np.float32)


def _close_to_scale(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1.0))


def _serve(engine, request_cls, prompts, max_new):
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in reqs)
    return [list(r.output) for r in reqs], engine.ticks


def test_engine_completes_requests_like_the_reference(pair):
    """``test_serve_engine_completes_requests``' setup: 7 requests, 3 slots,
    cache 64."""
    ref_model, params, model = pair
    prompts = [np.array([1 + i, 2, 3]) for i in range(7)]
    want, ref_ticks = _serve(RefServeEngine(ref_model, params, batch=3, cache_len=64),
                             RefRequest, prompts, [6] * 7)
    got, ticks = _serve(ServeEngine(model, batch=3, cache_len=64), Request,
                        prompts, [6] * 7)
    assert all(len(o) == 6 for o in got)
    assert got == want and ticks == ref_ticks


def test_engine_matches_the_reference_on_ragged_prompts(pair):
    """launch/serve.py's request mix (prompts of 2-12 tokens), unequal budgets,
    more requests than slots."""
    ref_model, params, model = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, int(rng.integers(2, 12))) for _ in range(9)]
    max_new = [int(m) for m in rng.integers(1, 10, 9)]
    want, ref_ticks = _serve(RefServeEngine(ref_model, params, batch=4, cache_len=32),
                             RefRequest, prompts, max_new)
    got, ticks = _serve(ServeEngine(model, batch=4, cache_len=32), Request,
                        prompts, max_new)
    assert got == want and ticks == ref_ticks


def test_greedy_matches_manual_decode(pair):
    """Engine greedy output == a manual decode_step + argmax loop."""
    _, _, model = pair
    prompt = np.array([5, 9, 3], np.int32)
    cache = model.init_cache(1, 32)
    tok, out = int(prompt[0]), []
    for t in range(1, 8):
        logits, cache = model.decode_step(cache, torch.tensor([[tok]]),
                                          torch.tensor([t - 1], dtype=torch.int32))
        tok = int(prompt[t]) if t < len(prompt) else int(np.argmax(logits[0].numpy()))
        if t >= len(prompt):
            out.append(tok)
    got, _ = _serve(ServeEngine(model, batch=1, cache_len=32), Request, [prompt],
                    [len(out)])
    assert got[0] == out


def test_temperature_sampling_follows_its_seed(pair):
    _, _, model = pair
    prompts = [np.array([4, 2]), np.array([7, 7, 1])]

    def run(seed):
        eng = ServeEngine(model, batch=2, cache_len=32, seed=seed)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8, temperature=100.0)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [r.output for r in reqs]

    a, b = run(1), run(1)
    assert a == b
    assert all(0 <= t < 256 for o in a for t in o) and all(len(o) == 8 for o in a)
    assert run(2) != a


def test_eos_and_cache_end_finish_a_request(pair):
    _, _, model = pair
    eng = ServeEngine(model, batch=2, cache_len=8)
    first, _ = _serve(ServeEngine(model, batch=2, cache_len=64), Request,
                      [np.array([3, 1, 4])], [5])
    eos = first[0][2]
    # the token sampled at admission is not checked against eos; ticks are
    stop = next(i for i in range(1, 5) if first[0][i] == eos)
    r_eos = Request(uid=0, prompt=np.array([3, 1, 4]), max_new_tokens=50, eos_id=eos)
    r_long = Request(uid=1, prompt=np.array([2, 7]), max_new_tokens=50)
    eng.submit(r_eos)
    eng.submit(r_long)
    eng.run()
    assert r_eos.done and r_eos.output == first[0][:stop + 1]
    assert r_long.done and len(r_long.output) == 8 - 2   # stops at cache_len - 1


def test_launch_serve_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
         "--requests", "6", "--batch", "3", "--cache-len", "64",
         "--max-new-tokens", "5"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "served 6 requests, 30 tokens" in proc.stdout
    assert "on cpu" in proc.stdout


# ---------------------------------------------------------------------------
# mamba2 (SSM state in the cache)
# ---------------------------------------------------------------------------
def test_ssm_engine_matches_the_reference(ssm_pair):
    """launch/serve.py's request mix on mamba2's smoke model: the same
    tokens, ticks and final conv / SSM caches as the reference's engine."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, int(rng.integers(2, 12))) for _ in range(9)]
    max_new = [int(m) for m in rng.integers(1, 10, 9)]
    (ref_eng, ref_req), (eng, req) = _engines(ssm_pair, batch=4, cache_len=32)
    want, ref_ticks = _serve(ref_eng, ref_req, prompts, max_new)
    got, ticks = _serve(eng, req, prompts, max_new)
    assert got == want and ticks == ref_ticks
    for name in ("conv", "ssm"):
        _close_to_scale(eng.cache[name].float().numpy(), ref_eng.cache[name])


def test_ssm_admission_moves_the_other_slots_state_in_both_packages(ssm_pair):
    """Admitting a prompt runs ``decode_step`` for every slot, so slot 0's
    SSM state advances once per token of slot 1's prompt: idempotent for a
    KV cache, not for a recurrent state. Both engines do it, by the same
    amount."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 3), rng.integers(0, 256, 5)]
    moved = {}
    for eng, req in _engines(ssm_pair, batch=2, cache_len=32):
        eng.submit(req(uid=0, prompt=prompts[0], max_new_tokens=4))
        eng._admit()
        before = _ssm_state(eng, 0)
        eng.submit(req(uid=1, prompt=prompts[1], max_new_tokens=4))
        eng._admit()
        after = _ssm_state(eng, 0)
        moved[req] = (after, float(np.abs(after - before).max()),
                      float(np.abs(before).max()))
    (ref_after, ref_moved, ref_scale), (after, port_moved, _) = \
        moved[RefRequest], moved[Request]
    assert ref_moved > 0.5 * ref_scale
    assert port_moved == pytest.approx(ref_moved, rel=1e-4)
    _close_to_scale(after, ref_after)


def test_ssm_recycled_slot_keeps_its_state_in_both_packages(ssm_pair):
    """A finished request's slot is recycled without resetting its conv
    window or SSM state: the next request in it starts from what the last
    one left, unlike the same request on a fresh engine — in both packages,
    by the same amount."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 3), rng.integers(0, 256, 5)]
    gap = {}
    for (eng, req), (fresh, _) in zip(_engines(ssm_pair, batch=1, cache_len=32),
                                      _engines(ssm_pair, batch=1, cache_len=32)):
        eng.submit(req(uid=0, prompt=prompts[0], max_new_tokens=3))
        eng.run()
        eng.submit(req(uid=1, prompt=prompts[1], max_new_tokens=3))
        eng._admit()
        fresh.submit(req(uid=1, prompt=prompts[1], max_new_tokens=3))
        fresh._admit()
        recycled, new = _ssm_state(eng, 0), _ssm_state(fresh, 0)
        gap[req] = (float(np.abs(recycled - new).max()), float(np.abs(new).max()))
    (ref_gap, ref_scale), (port_gap, _) = gap[RefRequest], gap[Request]
    assert ref_gap > 0.1 * ref_scale
    assert port_gap == pytest.approx(ref_gap, rel=1e-4)


def test_launch_serve_runs_mamba2_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mamba2-370m",
         "--smoke", "--device", "cpu", "--requests", "5", "--batch", "2",
         "--cache-len", "64", "--max-new-tokens", "4"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "served 5 requests, 20 tokens" in proc.stdout
    assert "on cpu" in proc.stdout

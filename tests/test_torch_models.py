"""The port's model zoo (dense family) against the reference, on the CPU
(the SSM family: ``tests/test_torch_ssm.py``).

Configs are data copied across and must equal the reference's. The model
is qwen3's smoke config: the reference initialises its parameters
(``jax.random.PRNGKey(7)``), ``repro_torch.models.convert`` carries them
across, and both packages prefill and decode the same tokens (made from a
seed with numpy). float32 at 1e-5, element by element; a bfloat16 variant
with head_dim 128 (qwen3's full head width) at 2e-2 of each tensor's
largest magnitude. The bf16 bound is scaled because a bf16 matrix product
rounds its float32 sum once, and the two frameworks' CPU products sum in
another order: a rare one-unit flip in a hidden state (2^-8 relative) moves
every logit by up to a unit of the largest one (0.25 at |logit| ~ 40), small
logits included. Every other step agrees bit for bit in bf16 (silu is taken
op by op as ``jax.nn.silu`` lowers it). On CPU tensors the port's kernels
take their plain versions, so nothing is launched.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import build_model as ref_build_model
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import build_model, convert
from repro_torch.models.model import NOT_PORTED

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(7)
VARIANTS = {"float32": dict(dtype="float32"),
            "bfloat16_hd128": dict(dtype="bfloat16", head_dim=128)}
TOL = {"float32": 1e-5, "bfloat16_hd128": 2e-2}


def _pair(variant):
    """(reference model, reference params, port model) with the same weights."""
    changes = VARIANTS[variant]
    ref_cfg = dataclasses.replace(jconfigs.get_smoke_config("qwen3-0.6b"), **changes)
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-0.6b"), **changes)
    ref_model = ref_build_model(ref_cfg)
    params = ref_model.init(KEY)
    model = build_model(cfg, device="cpu")
    convert.load_reference(model, jax.tree.map(np.asarray, params))
    return ref_model, params, model


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(got, want, variant, **kw):
    got, want = _np(got), _np(want)
    tol = TOL[variant]
    atol = tol if variant == "float32" else tol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, **kw)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# ---------------------------------------------------------------------------
# configs: data copied across
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        mine, theirs = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
        assert mine.param_count(active_only=True) == theirs.param_count(active_only=True)
        assert mine.layer_kinds() == theirs.layer_kinds()
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS


def test_shapes_and_applicability_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in jconfigs.ARCH_IDS:
        for name, shape in configs.SHAPES.items():
            assert configs.applicable(configs.get_config(arch), shape) == \
                jconfigs.applicable(jconfigs.get_config(arch), jconfigs.SHAPES[name])
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


def test_qwen3_parameter_count_at_full_width():
    cfg = configs.get_config("qwen3-0.6b")
    model = build_model(dataclasses.replace(cfg, n_layers=1), device="meta")
    per_layer = sum(p.numel() for n, p in model.named_parameters()
                    if n.startswith("layers."))
    embed = cfg.vocab_size * cfg.d_model
    assert embed + cfg.d_model + cfg.n_layers * per_layer == 596_049_920
    assert cfg.n_layers * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2 == 114_688


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------
def test_state_names_cover_the_model():
    _, params, model = _pair("float32")
    state = convert.state_from_reference(jax.tree.map(np.asarray, params))
    assert set(state) == set(model.state_dict())
    assert "layers.1.attn.q_norm.scale" in state and "final_norm.scale" in state


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_matches_reference(variant):
    ref_model, params, model = _pair(variant)
    toks = _tokens(0, 2, 24, model.cfg.vocab_size)
    want, want_cache = jax.jit(ref_model.prefill)(params, {"tokens": jnp.asarray(toks)})
    got, cache = model.prefill(torch.from_numpy(toks))
    assert got.shape == (2, model.cfg.vocab_size) and got.dtype == model.dtype
    _close(got, want, variant)
    for name in ("k", "v"):
        assert cache[name].shape == want_cache[name].shape
        _close(cache[name], want_cache[name], variant)
    assert cache["pos"].tolist() == np.asarray(want_cache["pos"]).tolist()


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_step_matches_reference(variant):
    """Prefix prefill, then teacher-forced decode: logits and cache agree
    with the reference's at every step."""
    ref_model, params, model = _pair(variant)
    b, s, n = 2, 24, 16
    toks = _tokens(1, b, s, model.cfg.vocab_size)
    _, ref_cache = jax.jit(ref_model.prefill)(params, {"tokens": jnp.asarray(toks[:, :n])})
    _, cache = model.prefill(torch.from_numpy(toks[:, :n]))
    pad = [(0, 0), (0, 0), (0, s - n), (0, 0), (0, 0)]
    ref_cache = {k: (jnp.pad(v, pad) if k != "pos" else v) for k, v in ref_cache.items()}
    cache = {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, s - n)) if k != "pos" else v)
             for k, v in cache.items()}
    decode = jax.jit(ref_model.decode_step)
    for t in range(n, s):
        pos = np.full((b,), t, np.int32)
        want, ref_cache = decode(params, ref_cache, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(pos))
        got, cache = model.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]),
                                       torch.from_numpy(pos))
        _close(got, want, variant, err_msg=f"step {t}")
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name], variant)


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_decode_consistency(variant):
    """logits of (prefill n) + (teacher-forced decode of the rest) equal the
    full prefill's last logits (``tests/test_models.py:62``)."""
    _, _, model = _pair(variant)
    b, s, n = 2, 24, 16
    toks = torch.from_numpy(_tokens(2, b, s, model.cfg.vocab_size))
    full, _ = model.prefill(toks)
    _, prefix = model.prefill(toks[:, :n])
    cache = model.init_cache(b, s)
    cache["k"][:, :, :n] = prefix["k"]
    cache["v"][:, :, :n] = prefix["v"]
    for t in range(n, s):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1],
                                          torch.full((b,), t, dtype=torch.int32))
    atol = 1e-3 if variant == "float32" else 5e-2
    np.testing.assert_allclose(_np(logits), _np(full), rtol=atol, atol=atol)


def test_decode_writes_the_cache_in_place_at_pos():
    _, _, model = _pair("float32")
    cache = model.init_cache(3, 10)
    k_before = cache["k"]
    pos = torch.tensor([0, 4, 9], dtype=torch.int32)
    _, out = model.decode_step(cache, torch.tensor([[1], [2], [3]]), pos)
    assert out["k"] is k_before and torch.equal(out["pos"], pos)
    written = cache["k"].abs().sum(dim=(0, 3, 4)) > 0          # (B, S)
    assert written.nonzero().tolist() == [[0, 0], [1, 4], [2, 9]]


def test_cpu_path_launches_no_kernel_and_plain_twin_agrees():
    _, _, model = _pair("float32")
    twin = build_model(model.cfg, device="cpu", impl="plain")
    twin.load_state_dict(model.state_dict())
    toks = torch.from_numpy(_tokens(3, 2, 12, model.cfg.vocab_size))
    before = (fa.launch_count, rn.launch_count)
    got, _ = model.prefill(toks)
    assert (fa.launch_count, rn.launch_count) == before
    assert torch.equal(got, twin.prefill(toks)[0])


def test_seeded_init_is_deterministic_and_has_the_reference_scales():
    cfg = configs.get_smoke_config("qwen3-0.6b")
    a, b, c = (build_model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
               for seed in (3, 3, 4))
    for (name, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        if name.endswith(".scale"):
            assert torch.equal(pa, torch.ones_like(pa)), name
        else:
            assert not torch.equal(pa, pc), name
            fan_in = 1.0 if name == "embed" else pa.shape[0]
            assert pa.abs().max() <= 3 * fan_in ** -0.5 + 1e-6, name


@pytest.mark.parametrize("arch", [a for a in jconfigs.ARCH_IDS
                                  if jconfigs.get_config(a).family in NOT_PORTED])
def test_families_not_yet_ported_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(configs.get_smoke_config(arch), device="cpu")


def test_device_none_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(configs.get_smoke_config("qwen3-0.6b"))
    with pytest.raises(ValueError):
        build_model(configs.get_smoke_config("qwen3-0.6b"), device="cpu", impl="pallas")

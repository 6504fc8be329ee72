"""The port's LM serving stack against the JAX package's: configs, layers,
attention, prefill and ring-cache decode on the smoke configs of every
arch, the port's own prefill/decode consistency, and the serve CLI.

Parameters, tokens and the cross-attention sources (whisper's frames, the
VLM's patches) are made with numpy from a seed and given to both packages
(the JAX ``init_params`` keys each leaf with Python's salted ``hash``, so
its draws change from process to process).  The leaves the init makes zeros
or ones but which carry the recurrent slots' decay, bonus and token shift
(``a_log``, ``dt_bias``, ``w0``, ``u_bonus``, ``mu_*``) are drawn non-zero."""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import registry as jax_registry
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import SHAPES, registry
from repro_torch.convert import (lm_cache_from_reference,
                                 lm_params_from_reference)
from repro_torch.launch import serve
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.testing.train import fan_in_scale

SRC = Path(__file__).resolve().parent.parent / "src"
DENSE = ("phi3-mini-3.8b", "qwen3-14b", "gemma3-1b", "command-r-plus-104b")
ARCHS = registry.ARCH_IDS
# archs whose first slot is attention (the ring-cache decode test's params)
ATTN = tuple(a for a in ARCHS
             if registry.smoke_config(a).layer_pattern[0].kind == "attn")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 12


def _np_params(cfg, seed=0):
    """A parameter tree of the specs' shapes and scales, drawn by numpy."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if s.init == "zeros":
            return np.zeros(s.shape, np.float32)
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        std = s.scale if s.scale is not None else 1 / math.sqrt(s.shape[0])
        return (std * rng.standard_normal(s.shape)).astype(np.float32)
    params = tree_map(draw, TM.param_specs(cfg))
    _live_states(params, rng)
    return params


def _live_states(tree, rng):
    """In place: the decay, bonus and token-shift leaves drawn non-zero
    (after every other draw, so the dense archs' trees are unchanged)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            _live_states(v, rng)
        elif k in ("a_log", "dt_bias", "w0", "u_bonus"):
            tree[k] = (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.startswith("mu_"):
            tree[k] = rng.uniform(0.0, 1.0, v.shape).astype(np.float32)


def _source(cfg, b=B, seed=200):
    """The cross-attention source of a batch, as numpy: {"frames": ...}
    (encoder), {"patches": ...} (VLM) or {}."""
    if cfg.encoder is not None:
        name, length = "frames", cfg.encoder.n_frames
    elif cfg.cross_attn_source_len:
        name, length = "patches", cfg.cross_attn_source_len
    else:
        return {}
    x = 0.1 * np.random.default_rng(seed).standard_normal(
        (b, length, cfg.d_model))
    return {name: x.astype(np.float32)}


def _high_capacity(cfg):
    """MoE capacity factor 8.0 (the JAX tests'), so no pair is dropped and
    prefixes of a sequence route alike."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _models(arch, seed=0):
    cfg = registry.smoke_config(arch)
    p = _np_params(cfg, seed)
    return cfg, jax.tree.map(jnp.asarray, p), lm_params_from_reference(p,
                                                                       "cpu")


def _tokens(cfg, seq, seed=100):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, seq)).astype(np.int32)


def _rel(want, got) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-9))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_config_registry_equals_reference():
    assert registry.ARCH_IDS == jax_registry.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for arch in registry.ARCH_IDS:
        for fn in ("get_config", "smoke_config"):
            ours = dataclasses.asdict(getattr(registry, fn)(arch))
            theirs = dataclasses.asdict(getattr(jax_registry, fn)(arch))
            assert ours == theirs, (arch, fn)
    with pytest.raises(ValueError, match="unknown arch"):
        registry.get_config("nope")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_count_match_reference(arch):
    for cfg in (registry.get_config(arch), registry.smoke_config(arch)):
        ours = {p: s.shape for p, s in tree_leaves(TM.param_specs(cfg))}
        theirs = {jax.tree_util.keystr(p): s.shape for p, s in
                  jax.tree_util.tree_flatten_with_path(
                      JM.param_specs(cfg),
                      is_leaf=lambda x: hasattr(x, "axes"))[0]}
        assert ours == theirs
        assert TM.count_params(cfg) == JM.count_params(cfg)
    cfg = registry.smoke_config(arch)
    ours = {p: s.shape for p, s in tree_leaves(TM.cache_specs(cfg, 3, 10))}
    theirs = jax.tree.map(lambda s: s.shape, JM.cache_specs(cfg, 3, 10),
                          is_leaf=lambda x: hasattr(x, "axes"))
    assert ours == {p: s for p, s in tree_leaves(theirs)}


def test_init_params_is_seeded_with_the_spec_scales():
    cfg = registry.smoke_config("gemma3-1b")
    a = TM.init(cfg, torch.Generator().manual_seed(3))
    b = TM.init(cfg, torch.Generator().manual_seed(3))
    c = TM.init(cfg, torch.Generator().manual_seed(4))
    for (_, x), (_, y), (_, z) in zip(tree_leaves(a), tree_leaves(b),
                                      tree_leaves(c)):
        assert torch.equal(x, y) and x.dtype == torch.float32
    assert not torch.equal(a["embed"]["table"], c["embed"]["table"])
    assert float(a["embed"]["table"].std()) == pytest.approx(1.0, rel=0.05)
    # the JAX rule: std 1/sqrt(shape[0]), and a stacked leaf's shape[0] is
    # the group count
    wq = a["groups"]["slot0"]["attn"]["wq"]
    assert float(wq.std()) == pytest.approx(cfg.n_groups ** -0.5, rel=0.05)
    w = TM.init(registry.smoke_config("qwen3-14b"),
                torch.Generator().manual_seed(3))["groups"]["slot0"]["ffn"]
    assert float(w["w_up"].std()) == pytest.approx(2 ** -0.5, rel=0.05)
    assert torch.equal(a["final_norm"]["scale"], torch.ones(cfg.d_model))
    bf = TM.init(cfg, torch.Generator().manual_seed(3), torch.bfloat16)
    assert bf["embed"]["table"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layers_match_reference(dt):
    jdt, tdt = DTYPES[dt]
    tol = 1e-6 if dt == "f32" else 2e-2
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (B, S)).astype(np.int32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    assert _rel(JL.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6),
                TL.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-6)) \
        <= tol
    for theta in (1e4, 1e6):
        assert _rel(JL.apply_rope(jx, jnp.asarray(pos), theta),
                    TL.apply_rope(tx, torch.from_numpy(pos), theta)) <= tol
    assert _rel(JL.sinusoidal_positions(jnp.asarray(pos), 16),
                TL.sinusoidal_positions(torch.from_numpy(pos), 16)) <= 1e-5
    table = rng.standard_normal((50, 16)).astype(np.float32)
    toks = rng.integers(0, 50, (B, S))
    assert _rel(JL.embed({"table": jnp.asarray(table)}, jnp.asarray(toks), jdt),
                TL.embed({"table": torch.from_numpy(table)},
                         torch.from_numpy(toks), tdt)) == 0.0
    h16 = x[..., 0, :]
    assert _rel(JL.unembed(jnp.asarray(table), jnp.asarray(h16, jdt)),
                TL.unembed(torch.from_numpy(table),
                           torch.from_numpy(h16).to(tdt))) <= 1e-6
    p = _np_params(registry.smoke_config("qwen3-14b"))["groups"]["slot0"]
    ffn = {k: v[0] for k, v in p["ffn"].items()}
    h = rng.standard_normal((B, S, 64)).astype(np.float32)
    assert _rel(JL.mlp(jax.tree.map(lambda a: jnp.asarray(a, jdt), ffn),
                       jnp.asarray(h, jdt)),
                TL.mlp({k: torch.from_numpy(v).to(tdt)
                        for k, v in ffn.items()},
                       torch.from_numpy(h).to(tdt))) <= tol


def _attn_params(cfg, seed=2):
    p = _np_params(cfg, seed)["groups"]["slot0"]["attn"]
    p = tree_map(lambda a: a[0], p)
    return (jax.tree.map(jnp.asarray, p),
            tree_map(torch.from_numpy, p))


@pytest.mark.parametrize("causal,window,q_chunk,softcap", [
    (True, 0, 512, 0.0), (True, 4, 5, 0.0), (True, 0, 3, 30.0),
    (False, 0, 7, 0.0)])
@pytest.mark.parametrize("arch", ["qwen3-14b", "gemma3-1b"])
def test_multihead_attention_matches_reference(arch, causal, window, q_chunk,
                                               softcap):
    cfg = registry.smoke_config(arch)
    jp, tp = _attn_params(cfg)
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kw = dict(causal=causal, window=window, softcap=softcap,
              qk_norm=cfg.use_qk_norm, rope_theta=cfg.rope_theta,
              q_chunk=q_chunk, return_kv=True)
    jy, (jk, jv) = JA.multihead_attention(
        jp, jnp.asarray(x), jnp.asarray(x), q_pos=jnp.asarray(pos),
        k_pos=jnp.arange(S, dtype=jnp.int32), **kw)
    ty, (tk, tv) = TA.multihead_attention(
        tp, torch.from_numpy(x), torch.from_numpy(x),
        q_pos=torch.from_numpy(pos), k_pos=torch.arange(S, dtype=torch.int32),
        **kw)
    assert _rel(jy, ty) <= 1e-5
    assert _rel(jk, tk) <= 1e-6 and _rel(jv, tv) <= 1e-6


@pytest.mark.parametrize("arch", ATTN)
def test_decode_attention_wrapped_ring_matches_reference(arch):
    """Per-row positions before, at and past the ring's wrap: the output and
    the written cache rows agree with the JAX function's new cache."""
    cfg = registry.smoke_config(arch)
    jp, tp = _attn_params(cfg)
    rng = np.random.default_rng(4)
    tc, b = 4, 4
    ck = rng.standard_normal((b, tc, cfg.n_kv_heads, cfg.head_dim)).astype(
        np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 3, 4, 9], np.int32)
    jy, jk, jv = JA.decode_attention(
        jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        pos=jnp.asarray(pos), qk_norm=cfg.use_qk_norm,
        rope_theta=cfg.rope_theta)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ty = TA.decode_attention(tp, torch.from_numpy(x), tk, tv,
                             pos=torch.from_numpy(pos),
                             qk_norm=cfg.use_qk_norm,
                             rope_theta=cfg.rope_theta)
    assert _rel(jy, ty) <= 1e-5
    assert _rel(jk, tk) <= 1e-6 and _rel(jv, tv) <= 1e-6   # written in place
    np.testing.assert_array_equal(
        TA.ring_valid(torch.from_numpy(pos), tc).numpy(),
        [[1, 0, 0, 0], [1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1]])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _batches(cfg, toks):
    """The same batch (tokens and the cross-attention source) for both
    packages."""
    src = _source(cfg, toks.shape[0])
    jb = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v)
                                          for k, v in src.items()}}
    tb = {"tokens": torch.from_numpy(toks).long(),
          **{k: torch.from_numpy(v) for k, v in src.items()}}
    return jb, tb


def _prefill_decode(jm, tm, cfg, toks, dt):
    jdt, tdt = DTYPES[dt]
    jb, tb = _batches(cfg, toks[:, :S])
    jl, jc, jpos = JM.prefill(cfg, jm, jb, max_cache_len=S + 4, dtype=jdt)
    tl, tc, tpos = TM.prefill(cfg, tm, tb, max_cache_len=S + 4, dtype=tdt)
    jd, _ = JM.decode_step(cfg, jm, jc, jnp.asarray(toks[:, S:S + 1]), jpos,
                           dtype=jdt)
    td, _ = TM.decode_step(cfg, tm, tc, torch.from_numpy(
        toks[:, S:S + 1]).long(), tpos, dtype=tdt)
    assert torch.equal(tpos, torch.full((B,), S, dtype=torch.int32))
    return (jl, tl), (jd, td)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_f32(arch):
    cfg, jm, tm = _models(arch)
    pre, dec = _prefill_decode(jm, tm, cfg, _tokens(cfg, S + 1), "f32")
    assert _rel(*pre) <= 1e-4, _rel(*pre)
    assert _rel(*dec) <= 1e-4, _rel(*dec)


def _slot_inputs(cfg, params, i, seed=7):
    """Slot ``i``'s parameters, the shared block's and a cross-attention
    source, as numpy, for one-slot comparisons."""
    rng = np.random.default_rng(seed)
    sp = tree_map(lambda a: a[0], params["groups"][f"slot{i}"])
    shared = params.get("shared")
    src = (rng.standard_normal((B, cfg.cross_attn_source_len, cfg.d_model))
           .astype(np.float32) if cfg.layer_pattern[i].cross_attn else None)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return sp, shared, src, x


@pytest.mark.parametrize("arch", ARCHS)
def test_slots_match_reference_bf16(arch):
    """bf16, one layer at a time on the same input: the pattern's last slot
    (its shared or cross attention included) over a prefill and one decode
    step (ring write and recurrent states included) within 2e-2 of
    max|out|."""
    cfg = registry.smoke_config(arch)
    jdt, tdt = DTYPES["bf16"]
    i = cfg.period - 1
    slot = cfg.layer_pattern[i]
    sp, shared, src, x = _slot_inputs(cfg, _np_params(cfg), i)

    def jx(tree):
        return None if tree is None else jax.tree.map(
            lambda a: jnp.asarray(a, jdt), tree)

    def tx(tree):
        return None if tree is None else tree_map(
            lambda a: torch.from_numpy(np.asarray(a)).to(tdt), tree)

    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jy, jc, _ = JM._apply_slot_full(
        cfg, slot, jx(sp), jnp.asarray(x, jdt), positions=jnp.asarray(pos),
        k_pos=jnp.arange(S, dtype=jnp.int32), cross_src=jx(src),
        shared_params=jx(shared), causal=True, emit_cache=True,
        cache_len=S + 2)
    ty, tc, _ = TM._apply_slot_full(
        cfg, slot, tx(sp), torch.from_numpy(x).to(tdt),
        positions=torch.from_numpy(pos), k_pos=torch.arange(S),
        cross_src=tx(src), shared_params=tx(shared), causal=True,
        emit_cache=True, cache_len=S + 2)
    assert _rel(jy, ty) <= 2e-2
    xd = x[:, :1]
    jpos = jnp.full((B,), S, jnp.int32)
    jyd, _ = JM._apply_slot_decode(cfg, slot, jx(sp), jnp.asarray(xd, jdt),
                                   pos=jpos, cache=jc,
                                   shared_params=jx(shared))
    tyd = TM._apply_slot_decode(cfg, slot, tx(sp),
                                torch.from_numpy(xd).to(tdt),
                                pos=torch.full((B,), S, dtype=torch.int32),
                                cache=tc, shared_params=tx(shared))
    assert _rel(jyd, tyd) <= 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_bf16(arch):
    """The whole model in bf16.  The two packages round bf16 at other
    places (XLA's logistic is not torch's sigmoid) and the random layers
    amplify one-ulp differences to the order of the JAX package's own bf16
    error against its f32 logits, so the bound is 5e-2 relative L2 (one
    layer at a time, bf16 is held to 2e-2 above).  Weights at std
    1/sqrt(fan-in) (``repro_torch.testing.train.fan_in_scale``): at the
    init's std 1/sqrt(groups) the JAX package's own bf16 logits are 0.07 to
    0.23 from its f32 ones in L2 on zamba2-7b's smoke config (seeds 0-2),
    and 0.014-0.035 at fan-in scale."""
    cfg = registry.smoke_config(arch)
    p = fan_in_scale(cfg, _np_params(cfg))
    jm, tm = jax.tree.map(jnp.asarray, p), lm_params_from_reference(p, "cpu")
    for j, t in _prefill_decode(jm, tm, cfg, _tokens(cfg, S + 1), "bf16"):
        j = np.asarray(j, np.float64)
        err = np.linalg.norm(j - t.double().numpy()) / np.linalg.norm(j)
        assert err <= 5e-2, err


def test_decode_from_reference_cache():
    """A cache made by the JAX prefill, converted, decodes as JAX does."""
    cfg, jm, tm = _models("gemma3-1b")
    toks = _tokens(cfg, S + 1)
    _, jc, jpos = JM.prefill(cfg, jm, {"tokens": jnp.asarray(toks[:, :S])},
                             max_cache_len=S + 4, dtype=jnp.float32)
    jd, _ = JM.decode_step(cfg, jm, jc, jnp.asarray(toks[:, S:]), jpos,
                           dtype=jnp.float32)
    tc = lm_cache_from_reference(jax.tree.map(np.asarray, jc), "cpu")
    td, _ = TM.decode_step(cfg, tm, tc, torch.from_numpy(toks[:, S:]).long(),
                           torch.from_numpy(np.array(jpos)),
                           dtype=torch.float32)
    assert _rel(jd, td) <= 1e-4
    bf = lm_params_from_reference(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jm), "cpu")
    assert bf["embed"]["table"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """decode_step(prefill(x[:S]), x[S]) == prefill(x[:S+1]) logits: the
    port's ring caches, recurrent states, cross-attention caches and B9's
    plain version against the prefill (the counterpart of
    tests/test_models.py's check, MoE at its capacity factor 8.0)."""
    cfg = _high_capacity(registry.smoke_config(arch))
    params = TM.init(cfg, torch.Generator().manual_seed(0))
    _, full = _batches(cfg, _tokens(cfg, S + 1))
    toks = full["tokens"]
    ref, _, _ = TM.prefill(cfg, params, full, dtype=torch.float32)
    _, cache, pos = TM.prefill(cfg, params, {**full, "tokens": toks[:, :S]},
                               max_cache_len=S + 4, dtype=torch.float32)
    got, same = TM.decode_step(cfg, params, cache, toks[:, S:], pos,
                               dtype=torch.float32)
    assert same is cache
    assert _rel(ref, got) < 2e-3


def test_ring_cache_matches_prefill_restart():
    """gemma3 smoke (window 4 < T): prefilling 4 tokens and decoding the
    other 6 one by one equals prefilling all 10; the cache is written in
    place, so a clone keeps the old state."""
    cfg = registry.smoke_config("gemma3-1b")
    params = TM.init(cfg, torch.Generator().manual_seed(1))
    total = 10
    toks = torch.from_numpy(_tokens(cfg, total)).long()
    ref, _, _ = TM.prefill(cfg, params, {"tokens": toks}, dtype=torch.float32)
    logits, cache, pos = TM.prefill(cfg, params, {"tokens": toks[:, :4]},
                                    max_cache_len=total, dtype=torch.float32)
    kept = tree_map(torch.clone, cache)
    for t in range(4, total):
        logits, cache = TM.decode_step(cfg, params, cache, toks[:, t:t + 1],
                                       pos, dtype=torch.float32)
        pos = pos + 1
    assert _rel(ref, logits) < 2e-3
    assert not torch.equal(kept["slot0"]["k"], cache["slot0"]["k"])
    again, _ = TM.decode_step(cfg, params, kept, toks[:, 4:5],
                              torch.full((B,), 4, dtype=torch.int32),
                              dtype=torch.float32)
    first, _, _ = TM.prefill(cfg, params, {"tokens": toks[:, :5]},
                             dtype=torch.float32)
    assert _rel(first, again) < 2e-3


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def test_generate_is_seeded_and_greedy_matches_argmax():
    cfg = registry.smoke_config("qwen3-14b")
    params = TM.init(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, 6)).long()
    ids, t_pre, t_dec = serve.generate(cfg, params, toks, 5,
                                       generator=torch.Generator())
    assert ids.shape == (B, 5) and ids.dtype == torch.int32
    assert t_pre > 0 and t_dec > 0
    logits, _, _ = TM.prefill(cfg, params, {"tokens": toks},
                              dtype=torch.float32)
    assert torch.equal(ids[:, 0], logits.argmax(-1).to(torch.int32))
    full, _, _ = TM.prefill(cfg, params, {"tokens": torch.cat(
        [toks, ids[:, :1].long()], 1)}, dtype=torch.float32)
    assert torch.equal(ids[:, 1], full.argmax(-1).to(torch.int32))
    draws = [serve.generate(cfg, params, toks, 5, temperature=1.0,
                            generator=torch.Generator().manual_seed(s))[0]
             for s in (7, 7, 8)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])


def test_serve_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gemma3-1b", "--smoke"])


def test_serve_cli_cpu_smoke():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-1b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "9", "--gen", "6"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "prefill 2x9" in out.stdout and "tok/s" in out.stdout

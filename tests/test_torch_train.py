"""The port's LM training path against the JAX package's: the token
pipeline, ``chunked_xent`` and ``loss_fn`` with their gradients, AdamW,
int8 gradient compression, the train step (full and microbatched), the
restartable loop (a JAX-written checkpoint resumes in the port) and the
train CLI.

Parameters are drawn with numpy (``tests/test_torch_lm.py`` ``_np_params``)
and batches come from the JAX package's ``synthetic_lm_batch``; both are
given to the two packages as numpy arrays.

AdamW's first step divides each gradient by its own magnitude plus
eps = 1e-8, so an entry whose gradient is near eps moves by up to lr on
float32 reordering noise alone.  Parameters are therefore compared within
lr * 1e-3 only where |g| > 1e-5; elsewhere each package's update is held
to AdamW's own bound, |delta p| <= lr * (1 + wd * |p|)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.data import synthetic_lm_batch as jax_batch
from repro.launch import steps as JS
from repro.models import model as JM
from repro.optim import adamw as JO
from repro.optim import compression as JC
from repro_torch.configs import registry
from repro_torch.convert import (adamw_state_from_reference,
                                 lm_params_from_reference)
from repro_torch.data import synthetic_lm_batch, token_stream
from repro_torch.launch import steps as TS
from repro_torch.launch import train
from repro_torch.models import model as TM
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw as TO
from repro_torch.optim import compression as TC
from repro_torch.runtime import (FailureInjector, RestartableLoop,
                                 StragglerWatchdog)
from repro_torch.testing.multirank import spawn_ranks
from repro_torch.testing.train import fan_in_scale

from test_torch_lm import DENSE, _np_params

SRC = Path(__file__).resolve().parent.parent / "src"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=1, step=0, b=2, s=20):
    """The JAX package's batch, as numpy and as the port's tensors."""
    jb = _np(jax_batch(seed, step, batch=b, seq=s, vocab=cfg.vocab_size))
    return jb, {k: torch.from_numpy(v).long() for k, v in jb.items()}


def _max_rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().float() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-30))


def _port_grads(cfg, params, batch, dtype):
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    total, metrics = TM.loss_fn(cfg, leaves, batch, dtype=dtype)
    total.backward()
    return float(metrics["loss"]), tree_map(lambda p: p.grad, leaves)


def _conditioning(cfg, params, batch, grads, dtype=torch.float32):
    """Per leaf, how far the port's gradient moves, in units of the leaf's
    max|g|, when every parameter is moved by half an ulp of ``dtype`` (a
    relative 2^-24 for float32, 2^-8 for bf16, random sign): the floor of a
    gradient comparison in that dtype at these inputs.  In float32 on
    phi3-mini-3.8b's and gemma3-1b's smoke configs it passes 1e-4 at some
    seeds (their stacked weights are drawn at std 1/sqrt(groups), so
    attention scores are near one-hot)."""
    rng = np.random.default_rng(99)
    ulp = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
    moved = tree_map(lambda a: (a * (1 + ulp * rng.choice(
        [-1.0, 1.0], a.shape))).astype(np.float32), params)
    _, g2 = _port_grads(cfg, lm_params_from_reference(moved, "cpu"), batch,
                        dtype)
    return {path: _max_rel(a.numpy(), b)
            for (path, a), (_, b) in zip(tree_leaves(grads),
                                         tree_leaves(g2))}


def _fan_in_params(cfg, seed=0):
    """``_np_params`` with each stacked weight at std 1/sqrt(its fan-in)
    instead of 1/sqrt(groups) (``repro_torch.testing.train.fan_in_scale``).
    Attention is then far from one-hot, and the JAX package's own bf16
    gradient is 0.007-0.025 of its float32 one in L2 on the four dense
    smoke configs."""
    return fan_in_scale(cfg, _np_params(cfg, seed))


def _jax_grads(cfg, params, batch, dtype):
    (_, m), g = jax.value_and_grad(
        lambda p: JM.loss_fn(cfg, p, jax.tree.map(jnp.asarray, batch),
                             dtype=dtype), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    return float(m["loss"]), _np(g)


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------

def test_synthetic_batches_deterministic_and_resumable():
    a = synthetic_lm_batch(7, 42, batch=4, seq=32, vocab=101, device="cpu")
    b = synthetic_lm_batch(7, 42, batch=4, seq=32, vocab=101, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == torch.int64 and a["tokens"].shape == (4, 32)
    for other in ((8, 42), (7, 43)):
        c = synthetic_lm_batch(*other, batch=4, seq=32, vocab=101,
                               device="cpu")
        assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert bool((a["labels"][:, -1] == -1).all())
    assert bool(((a["tokens"] >= 0) & (a["tokens"] < 101)).all())
    stream = token_stream(7, batch=4, seq=32, vocab=101, start_step=41,
                          device="cpu")
    assert next(stream)[0] == 41
    step, again = next(stream)
    assert step == 42 and torch.equal(again["tokens"], a["tokens"])


def test_synthetic_stream_is_learnable_structure():
    """Most transitions follow the affine recurrence (noise = 0.1), as in
    the JAX package's stream."""
    t = synthetic_lm_batch(0, 0, batch=8, seq=256, vocab=997,
                           noise=0.1, device="cpu")["tokens"]
    frac = float(((t[:, :-1] * 4097 + 1231) % 997 == t[:, 1:]).float()
                 .mean())
    assert 0.8 < frac < 0.95, frac


def test_synthetic_batches_default_to_the_card():
    """None is the card, as for every entry point of the port: without one
    the batch raises instead of staying on the host."""
    if torch.cuda.is_available():
        a = synthetic_lm_batch(7, 42, batch=2, seq=8, vocab=101)
        assert a["tokens"].device.type == "cuda"
        _, b = next(token_stream(7, batch=2, seq=8, vocab=101))
        assert b["labels"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_lm_batch(7, 42, batch=2, seq=8, vocab=101)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(token_stream(7, batch=2, seq=8, vocab=101))


# ---------------------------------------------------------------------------
# chunked cross-entropy and the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_chunked_xent_matches_reference(dt):
    """S = 37 over chunks of 8 (a ragged last chunk), -1 masks inside a row
    and on the last column, a tied (V, D) table: the loss and its gradient
    with respect to h and the table within 1e-5 of max|.| in f32.  In bf16
    both packages cast h and the table to bf16 and take float32 products,
    so the limit is 1e-4 (summation order only)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    tol = 1e-5 if dt == "f32" else 1e-4
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 37, 16)).astype(np.float32)
    table = (0.3 * rng.standard_normal((50, 16))).astype(np.float32)
    lab = rng.integers(0, 50, (2, 37)).astype(np.int32)
    lab[:, -1] = -1
    lab[0, 5:9] = -1
    jl, (gh, gt) = jax.value_and_grad(
        lambda hh, tt: JM.chunked_xent(hh.astype(jdt), tt, jnp.asarray(lab),
                                       chunk=8), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(table))
    th = torch.from_numpy(h).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    tl = TM.chunked_xent(th.to(tdt), tt, torch.from_numpy(lab).long(),
                         chunk=8)
    tl.backward()
    assert abs(float(tl) - float(jl)) <= tol * abs(float(jl))
    assert _max_rel(gh, th.grad) <= tol and _max_rel(gt, tt.grad) <= tol
    with torch.no_grad():
        again = TM.chunked_xent(th.to(tdt), tt, torch.from_numpy(lab).long(),
                                chunk=8)
    assert float(again) == float(tl)
    assert TM.XENT_CHUNK == JM.XENT_CHUNK == 512
    assert TM.AUX_LOSS_WEIGHT == JM.AUX_LOSS_WEIGHT


def test_logits_gradient_rounds_once_as_the_reference():
    """The bf16 logits product with a float32 result and its gradients
    against the float32 product of the same bf16 values (h a float32 leaf,
    the table's rounding passed straight through), at (2, 256, 512)
    x a 3000-row table: the JAX package's (``preferred_element_type``; its
    transpose multiplies the float32 cotangent and rounds only the result)
    and the port's CPU path are each within one bf16 rounding of the
    reference (2^-8 of max), the limit the card's ``_LogitsF32`` is held to
    (``repro_torch.testing.train``).  Run with -s to print the readings."""
    from repro_torch.testing.train import ROUNDING, logits_grad_errors
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 256, 512)).astype(np.float32)
    table = (0.05 * rng.standard_normal((3000, 512))).astype(np.float32)
    gout = rng.standard_normal((2, 256, 3000)).astype(np.float32)
    hb = jnp.asarray(h).astype(jnp.bfloat16)

    def run(ref):
        def f(x, t):
            tb = t.astype(jnp.bfloat16)
            if ref:     # the rounding passed straight through
                tr = t + jax.lax.stop_gradient(tb.astype(jnp.float32) - t)
                out = jnp.einsum("bcd,vd->bcv", x, tr)
            else:
                out = jnp.einsum("bcd,vd->bcv", x, tb,
                                 preferred_element_type=jnp.float32)
            return jnp.sum(out * gout), out
        x = hb.astype(jnp.float32) if ref else hb
        (_, out), grads = jax.value_and_grad(f, (0, 1), has_aux=True)(
            x, jnp.asarray(table))
        return [np.asarray(a, np.float64) for a in (out,) + grads]

    got, want = run(False), run(True)
    jax_errs = [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(got, want)]
    dtype, errs = logits_grad_errors(torch.from_numpy(h),
                                     torch.from_numpy(table),
                                     torch.from_numpy(gout))
    print(f"logits, grad h, grad table against float32: JAX {jax_errs}, "
          f"the port's CPU path {errs}")
    assert got[0].dtype == np.float64 and dtype == torch.float32
    for e in (jax_errs, errs):
        assert e[0] <= 1e-5 and max(e[1:]) <= ROUNDING, e


def test_chunked_xent_masks_everything():
    """All labels masked: the mean is over max(count, 1), so 0."""
    h = torch.randn(1, 5, 4)
    out = TM.chunked_xent(h, torch.randn(7, 4), torch.full((1, 5), -1))
    assert float(out) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_fn_and_grads_match_reference_f32(arch, seed):
    """The loss within 1e-5 relative; each gradient leaf within 1e-4 of its
    max|g|, or within 4x the leaf's float32 floor at these inputs where
    that is larger (``_conditioning``: half an ulp on the parameters moves
    phi3's and gemma3's smoke gradients past 1e-4); remat active (autograd
    records), and the loss under no_grad (no remat) the same."""
    cfg = registry.smoke_config(arch)
    p = _np_params(cfg, seed)
    jb, tb = _batch(cfg, seed=seed + 1)
    jl, jg = _jax_grads(cfg, p, jb, jnp.float32)
    tl, tg = _port_grads(cfg, lm_params_from_reference(p, "cpu"), tb,
                         torch.float32)
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    floor = _conditioning(cfg, p, tb, tg)
    for (path, a), (_, b) in zip(tree_leaves(jg), tree_leaves(tg)):
        assert _max_rel(a, b) <= max(1e-4, 4 * floor[path]), \
            (path, _max_rel(a, b), floor[path])
    with torch.no_grad():
        total, m = TM.loss_fn(cfg, lm_params_from_reference(p, "cpu"), tb,
                              dtype=torch.float32)
    assert abs(float(m["loss"]) - tl) <= 1e-6 * abs(tl)
    assert float(m["aux_loss"]) == 0.0 and float(total) == float(m["loss"])
    ev = TS.make_eval_step(cfg, dtype=torch.float32)(
        lm_params_from_reference(p, "cpu"), tb)
    assert float(ev["loss"]) == float(m["loss"])


@pytest.mark.parametrize("arch", DENSE)
def test_loss_fn_and_grads_match_reference_bf16(arch):
    """bf16 compute from f32 master parameters, every gradient leaf float32.
    Parameters from ``_fan_in_params``, where the bf16 gradient is a fair
    estimate of the f32 one (the JAX package's own bf16 error is 0.007-0.025
    in L2).  Each leaf of the port's bf16 gradient is held to the JAX
    package's bf16 gradient within 2x its bf16 floor (``_conditioning``:
    how far the port's bf16 gradient moves when the parameters move by half
    a bf16 ulp; 0.012-0.11 of the leaf's max|g| here, and the two packages
    differ by at most 0.78x it).  The check is shown to reject a zero
    gradient and the gradient of half the batch (at least 9x the floor).  The loss within 5e-3
    relative of the JAX bf16 loss."""
    cfg = registry.smoke_config(arch)
    p = _fan_in_params(cfg)
    jb, tb = _batch(cfg)
    jl, jg = _jax_grads(cfg, p, jb, jnp.bfloat16)
    tp = lm_params_from_reference(p, "cpu")
    tl, tg = _port_grads(cfg, tp, tb, torch.bfloat16)
    assert abs(tl - jl) <= 5e-3 * abs(jl), (tl, jl)
    assert all(t.dtype == torch.float32 for _, t in tree_leaves(tg))
    floor = _conditioning(cfg, p, tb, tg, torch.bfloat16)

    def worst(grads):
        return max(_max_rel(a, b) / (2 * floor[path]) for (path, a), (_, b)
                   in zip(tree_leaves(jg), tree_leaves(grads)))

    assert worst(tg) <= 1.0, worst(tg)
    _, half = _port_grads(cfg, tp, {k: v[:1] for k, v in tb.items()},
                          torch.bfloat16)
    assert worst(tree_map(torch.zeros_like, tg)) > 1.0
    assert worst(half) > 1.0


@pytest.mark.parametrize("arch,calls", [("gemma3-1b", 6 + 1),
                                        ("qwen3-14b", 2 + 1)])
def test_remat_follows_the_reference(monkeypatch, arch, calls):
    """Checkpointed regions as the JAX package's: each slot when the
    pattern's period is above 4 (gemma3's smoke pattern: 6 slots, one
    group), else each group (qwen3: 2 groups of 1), plus one a chunk of the
    cross-entropy (S = 20: one chunk); none without autograd."""
    cfg = registry.smoke_config(arch)
    seen = []
    real = TM.checkpoint

    def counting(fn, *args, **kw):
        seen.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(TM, "checkpoint", counting)
    _, tb = _batch(cfg)
    params = lm_params_from_reference(_np_params(cfg), "cpu")
    _port_grads(cfg, params, tb, torch.float32)
    assert len(seen) == calls, seen
    assert seen[-1] == "_xent_chunk"
    seen.clear()
    with torch.no_grad():
        TM.loss_fn(cfg, params, tb, dtype=torch.float32)
    assert seen == []


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"a": (scale * rng.standard_normal((4, 3))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal(5)).astype(np.float32)}}


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference(clip):
    """Five steps on numpy trees (gradients of norm ~4: clipped at
    clip_norm 1, not at 100): params, m, v, step and the metrics within
    1e-6 of max|.|, the schedule's warmup and decay included."""
    rng = np.random.default_rng(3)
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                         clip_norm=clip)
    jcfg = JO.AdamWConfig(**cfg._asdict())
    p = _tree(rng)
    jp, js = jax.tree.map(jnp.asarray, p), JO.adamw_init(p)
    tp = tree_map(torch.from_numpy, p)
    ts = TO.adamw_init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for _ in range(5):
        g = _tree(rng)
        jp, js, jm = JO.adamw_update(jcfg, jax.tree.map(jnp.asarray, g), js,
                                     jp)
        before = tree_map(torch.clone, tp)
        tp, ts, tm = TO.adamw_update(cfg, tree_map(torch.from_numpy, g), ts,
                                     tp)
        for (_, x), (_, y) in zip(tree_leaves(before),
                                  tree_leaves(tree_map(torch.clone, before))):
            assert torch.equal(x, y)
        assert int(ts.step) == int(js.step)
        for name in ("grad_norm", "lr"):
            assert _max_rel(np.asarray(jm[name]), tm[name]) <= 1e-6, name
        for jt, tt in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            for (path, a), (_, b) in zip(tree_leaves(_np(jt)),
                                         tree_leaves(tt)):
                assert _max_rel(a, b) <= 1e-6, path


def test_adamw_update_leaves_its_inputs_alone():
    p = {"w": torch.ones(3)}
    st = TO.adamw_init(p)
    new_p, new_st, _ = TO.adamw_update(TO.AdamWConfig(warmup_steps=0), {
        "w": torch.ones(3)}, st, p)
    assert torch.equal(p["w"], torch.ones(3)) and int(st.step) == 0
    assert float(st.m["w"].abs().sum()) == 0.0
    assert not torch.equal(new_p["w"], p["w"]) and int(new_st.step) == 1
    bf = {"w": torch.ones(3, dtype=torch.bfloat16)}
    out, st2, _ = TO.adamw_update(TO.AdamWConfig(warmup_steps=0),
                                  {"w": torch.ones(3)}, TO.adamw_init(bf), bf)
    assert out["w"].dtype == torch.bfloat16
    assert st2.m["w"].dtype == st2.v["w"].dtype == torch.float32


def test_cosine_schedule_matches_reference():
    cfg = TO.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                         min_lr_frac=0.1)
    jcfg = JO.AdamWConfig(**cfg._asdict())
    for s in (0, 1, 5, 10, 11, 37, 60, 109, 110, 500):
        want = float(JO.cosine_schedule(jcfg, jnp.asarray(s)))
        got = TO.cosine_schedule(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-7), s
    # the endpoints (tests/test_substrate.py's counterpart)
    assert float(TO.cosine_schedule(cfg, torch.tensor(0))) == 0.0
    assert float(TO.cosine_schedule(cfg, torch.tensor(10))) == \
        pytest.approx(1.0, abs=0.01)
    assert float(TO.cosine_schedule(cfg, torch.tensor(110))) == \
        pytest.approx(0.1, abs=0.01)


def test_adamw_converges_on_quadratic():
    params = {"w": torch.full((8,), 5.0)}
    st = TO.adamw_init(params)
    cfg = TO.AdamWConfig(lr=0.3, weight_decay=0.0, warmup_steps=0,
                         total_steps=200, clip_norm=100.0)
    for _ in range(150):
        grads = tree_map(lambda p: 2 * p, params)
        params, st, _ = TO.adamw_update(cfg, grads, st, params)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clipping_caps_update_norm():
    params = {"w": torch.zeros(4)}
    cfg = TO.AdamWConfig(lr=1.0, clip_norm=1.0, warmup_steps=0,
                         total_steps=10, weight_decay=0.0)
    _, _, metrics = TO.adamw_update(cfg, {"w": torch.full((4,), 100.0)},
                                    TO.adamw_init(params), params)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert float(TO.global_norm({"a": torch.full((3,), 2.0),
                                 "b": {"c": torch.full((1,), 2.0)}})) == 4.0


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------

def test_quantize_matches_reference_given_the_same_noise():
    """The JAX quantizer's own uniform draw, given to the port's: q and the
    scale bitwise, dequantize equal."""
    x = (3.0 * np.random.default_rng(5).standard_normal(4096)).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    jq, js = JC.quantize_int8(jnp.asarray(x), key)
    noise = np.asarray(jax.random.uniform(key, x.shape))
    tq, ts = TC.stochastic_round_int8(torch.from_numpy(x),
                                      torch.from_numpy(noise))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    assert float(js) == float(ts)
    np.testing.assert_array_equal(np.asarray(JC.dequantize_int8(jq, js)),
                                  TC.dequantize_int8(tq, ts).numpy())


def test_int8_quantization_unbiased_and_bounded():
    x = 3.0 * torch.randn(4096, generator=torch.Generator().manual_seed(0))
    q, scale = TC.quantize_int8(x, torch.Generator().manual_seed(1))
    err = TC.dequantize_int8(q, scale) - x
    assert float(err.abs().max()) <= float(scale) + 1e-6
    reps = torch.stack([TC.dequantize_int8(*TC.quantize_int8(
        x, torch.Generator().manual_seed(100 + i))) for i in range(128)])
    bias = reps.mean(0) - x
    assert float(bias.abs().max()) < 4 * float(scale) / np.sqrt(128)


@pytest.fixture
def one_rank_group(tmp_path):
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
    yield dist.group.WORLD
    if own:
        dist.destroy_process_group()


def test_compressed_psum_one_rank(one_rank_group):
    """The collective runs on a one-rank group: the sum is the input within
    one quantization step, and one seed gives one answer."""
    x = torch.linspace(-2.0, 2.0, 256)
    out = TC.compressed_psum(x, one_rank_group,
                             torch.Generator().manual_seed(0))
    scale = float(x.abs().max()) / 127.0
    assert float((out - x).abs().max()) <= scale + 1e-6
    again = TC.compressed_psum(x, one_rank_group,
                               torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def test_compressed_psum_two_ranks(tmp_path):
    """Two gloo ranks: both return the same tensor, within the sum of the
    two ranks' quantization steps of the exact sum."""
    rng = np.random.default_rng(2)
    xs = np.stack([rng.standard_normal(300), 4 * rng.standard_normal(300)]
                  ).astype(np.float32)
    inputs = dict(x=np.zeros((4, 3), np.float32), y=np.zeros(4, np.float32),
                  xq=np.zeros((2, 3), np.float32),
                  w=np.ones((2, 3), np.float32),
                  z=np.zeros((2, 3), np.float32),
                  r1=np.ones((2, 3), np.uint32), r2=np.ones((2, 3), np.uint32))
    res = spawn_ranks(2, 1, str(tmp_path), inputs,
                      [("cps", dict(mode="compressed_psum", x=xs, seed=4))])
    a, b = (r["cps"]["sum"] for r in res)
    assert torch.equal(a, b)
    bound = sum(float(np.abs(r).max()) / 127.0 for r in xs)
    assert float((a - torch.from_numpy(xs.sum(0))).abs().max()) <= \
        bound + 1e-5


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)


def _assert_step_params(p_ref, p_got, grads, p_before, lr, wd):
    """p_got within lr * 1e-3 of p_ref where |g| > 1e-5; elsewhere both
    updates bounded by lr * (1 + wd * |p|) (plus the float32 rounding of
    the new parameter)."""
    for (path, a), (_, b), (_, g), (_, p0) in zip(
            tree_leaves(p_ref), tree_leaves(p_got), tree_leaves(grads),
            tree_leaves(p_before)):
        a, b, g, p0 = (np.asarray(t.detach() if isinstance(t, torch.Tensor)
                                  else t, np.float64) for t in (a, b, g, p0))
        big = np.abs(g) > 1e-5
        assert np.abs(a - b)[big].max(initial=0.0) <= lr * 1e-3, path
        # AdamW's first-step bound, plus the float32 rounding of p
        cap = lr * (1 + wd * np.abs(p0)) * (1 + 1e-5) + 2.0 ** -23 * \
            np.abs(p0)
        for upd in (a - p0, b - p0):
            assert (np.abs(upd)[~big] <= cap[~big]).all(), path


def test_train_step_matches_reference():
    """qwen3-14b smoke, f32: three JAX steps; each time the port steps from
    the same state (converted with ``adamw_state_from_reference``):
    gradients within 1e-4 of each leaf's max, loss, grad_norm and lr within
    1e-5 relative, m, v and parameters by the |g| rule; then the port's own
    three steps, whose losses follow JAX's within 1e-5 relative."""
    cfg = registry.smoke_config("qwen3-14b")
    p0 = _np_params(cfg)
    jcfg, tcfg = JO.AdamWConfig(**OPT), TO.AdamWConfig(**OPT)
    jstep = JS.make_train_step(cfg, jcfg, dtype=jnp.float32)
    tstep = TS.make_train_step(cfg, tcfg, dtype=torch.float32)
    jp, jo = jax.tree.map(jnp.asarray, p0), JO.adamw_init(p0)
    own_p = lm_params_from_reference(p0, "cpu")
    own_o = TO.adamw_init(own_p)
    jlosses, own = [], []
    for k in range(3):
        jb, tb = _batch(cfg, seed=1, step=k, b=4, s=16)
        p_np, o_np = _np(jp), _np(jo)
        _, jg = _jax_grads(cfg, p_np, jb, jnp.float32)
        _, tg = _port_grads(cfg, lm_params_from_reference(p_np, "cpu"), tb,
                            torch.float32)
        for (path, a), (_, b) in zip(tree_leaves(jg), tree_leaves(tg)):
            assert _max_rel(a, b) <= 1e-4, (k, path)
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, jb))
        tp, to, tm = tstep(lm_params_from_reference(p_np, "cpu"),
                           adamw_state_from_reference(o_np, "cpu"), tb)
        assert int(to.step) == int(jo.step) == k + 1
        for name in ("loss", "grad_norm", "lr"):
            want = float(jm[name])
            assert abs(float(tm[name]) - want) <= 1e-5 * abs(want), name
        lr = float(jm["lr"])
        _assert_step_params(_np(jp), tp, jg, p_np, lr, jcfg.weight_decay)
        for jt, tt in ((jo.m, to.m), (jo.v, to.v)):
            for (path, a), (_, b) in zip(tree_leaves(_np(jt)),
                                         tree_leaves(tt)):
                assert _max_rel(a, b) <= 1e-4, (k, path)
        jlosses.append(float(jm["loss"]))
        own_p, own_o, m = tstep(own_p, own_o, tb)
        own.append(float(m["loss"]))
    np.testing.assert_allclose(own, jlosses, rtol=1e-5)


def test_microbatched_train_step_matches_full():
    """Two microbatches against the whole batch (qwen3-14b smoke, f32):
    loss and grad_norm within 1e-5 relative, the update by the |g| rule
    (not a flat atol: near-eps gradients make the first step sign noise).
    """
    cfg = registry.smoke_config("qwen3-14b")
    p0 = _np_params(cfg)
    _, tb = _batch(cfg, seed=1, step=0, b=4, s=16)
    tcfg = TO.AdamWConfig(**OPT)
    params = lm_params_from_reference(p0, "cpu")
    p1, o1, m1 = TS.make_train_step(cfg, tcfg, dtype=torch.float32)(
        params, TO.adamw_init(params), tb)
    p2, o2, m2 = TS.make_train_step(cfg, tcfg, dtype=torch.float32,
                                    num_microbatches=2)(
        params, TO.adamw_init(params), tb)
    for name in ("loss", "grad_norm"):
        assert abs(float(m1[name]) - float(m2[name])) <= \
            1e-5 * abs(float(m1[name])), name
    _, g = _port_grads(cfg, params, tb, torch.float32)
    _assert_step_params(p1, p2, g, params, float(m1["lr"]), tcfg.weight_decay)
    with pytest.raises(ValueError, match="microbatches"):
        TS.make_train_step(cfg, tcfg, num_microbatches=3)(
            params, TO.adamw_init(params), tb)


def test_train_step_reduces_loss():
    """60 steps at the phi3 smoke config (tests/test_models.py's
    counterpart): the last 5 losses at least 0.3 below the first 5."""
    cfg = registry.smoke_config("phi3-mini-3.8b")
    params, opt = TS.init_train_state(cfg, torch.Generator().manual_seed(0))
    step = TS.make_train_step(cfg, TO.AdamWConfig(lr=5e-3, warmup_steps=5,
                                                  total_steps=60),
                              dtype=torch.float32)
    losses = []
    for i in range(60):
        batch = synthetic_lm_batch(0, i, batch=8, seq=64,
                                   vocab=cfg.vocab_size, device="cpu")
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, \
        losses[:3] + losses[-3:]


# ---------------------------------------------------------------------------
# the restartable loop
# ---------------------------------------------------------------------------

def test_restartable_loop_exactly_once_semantics(tmp_path):
    def step_fn(state, step):
        return {"x": state["x"] + 1.0,
                "acc": state["acc"] + step}, {"step": step}

    loop = RestartableLoop(step_fn, str(tmp_path), checkpoint_every=4,
                           injector=FailureInjector(at_steps=(5, 6, 11)))
    res = loop.run({"x": torch.zeros(()), "acc": torch.zeros(())}, 16)
    assert float(res.state["x"]) == 16.0
    assert float(res.state["acc"]) == sum(range(16))
    assert loop.restarts == 3 and res.step == 16
    assert isinstance(res.state["x"], torch.Tensor)


def test_restartable_loop_gives_up_after_max_restarts(tmp_path):
    def bad_step(state, step):
        raise RuntimeError("always broken")

    loop = RestartableLoop(bad_step, str(tmp_path), max_restarts=2)
    with pytest.raises(RuntimeError, match="always broken"):
        loop.run({"x": torch.zeros(())}, 4)
    assert loop.restarts == 3


def test_straggler_watchdog_flags_outliers():
    wd = StragglerWatchdog(slow_factor=3.0)
    for i in range(20):
        wd.observe(i, 0.1)
    wd.observe(20, 1.0)
    assert len(wd.stragglers) == 1
    with pytest.raises(TimeoutError):
        StragglerWatchdog(hard_timeout_s=0.5).observe(0, 1.0)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package trains two steps and writes {"params", "opt"} at
    step 2; the port's RestartableLoop, given a template of the same
    shapes, resumes there (the AdamW step, m and v included) and its next
    loss equals JAX's step 2 loss within 1e-5 relative."""
    cfg = registry.smoke_config("qwen3-14b")
    p0 = _np_params(cfg)
    jcfg = JO.AdamWConfig(**OPT)
    jstep = JS.make_train_step(cfg, jcfg, dtype=jnp.float32)
    batches = [_batch(cfg, seed=3, step=k, b=4, s=16) for k in range(3)]
    jp, jo = jax.tree.map(jnp.asarray, p0), JO.adamw_init(p0)
    for k in range(2):
        jp, jo, _ = jstep(jp, jo, jax.tree.map(jnp.asarray, batches[k][0]))
    jax_save_checkpoint(str(tmp_path), 2, {"params": jp, "opt": jo})
    _, _, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, batches[2][0]))

    tstep = TS.make_train_step(cfg, TO.AdamWConfig(**OPT),
                               dtype=torch.float32)
    template, topt = TS.init_train_state(cfg,
                                         torch.Generator().manual_seed(9))
    seen = {}

    def loop_step(state, step):
        p, o, m = tstep(state["params"], state["opt"], batches[step][1])
        seen[step] = float(m["loss"])
        return {"params": p, "opt": o}, m

    loop = RestartableLoop(loop_step, str(tmp_path), checkpoint_every=100)
    res = loop.run({"params": template, "opt": topt}, 3)
    assert list(seen) == [2] and res.step == 3
    assert int(res.state["opt"].step) == 3
    assert res.state["opt"].step.dtype == torch.int32
    assert abs(seen[2] - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_train_cli_restarts_and_learns(tmp_path):
    """gemma3-1b smoke on the CPU with a failure injected at step 3 before
    any checkpoint: one restart from the initial state, and the loss falls
    (exit 0: the mean of the last 10 losses below the first 10's)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma3-1b", "--smoke", "--device", "cpu", "--steps", "14",
         "--batch", "2", "--seq", "16", "--fail-at", "3", "--ckpt-every",
         "50", "--ckpt-dir", str(tmp_path / "ck")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "restarts=1" in out.stdout, out.stdout
    assert "done: 14 steps" in out.stdout


def test_train_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "gemma3-1b", "--smoke", "--steps", "1"])

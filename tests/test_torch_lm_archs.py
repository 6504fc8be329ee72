"""Whole archs of the port against the JAX package's, on the smoke configs
of all ten registry archs: the forward's hidden state and MoE auxiliary
loss, ``loss_fn``, the caches ``prefill`` emits and ``decode_step``
updates (values and dtypes), the gradient of ``loss_fn`` for the archs
with MoE, Mamba2, RWKV6, shared or cross attention or an encoder,
rematerialization, and the serve and train CLIs for one arch of each
family.

Parameters, batches and cross-attention sources are made with numpy
(``tests/test_torch_lm.py``) and given to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.configs import registry
from repro_torch.convert import lm_cache_from_reference, \
    lm_params_from_reference
from repro_torch.launch import serve, train
from repro_torch.models import model as TM
from repro_torch.models import rwkv6 as TRW
from repro_torch.models.params import tree_leaves
from repro_torch.testing.train import fan_in_scale

from test_torch_lm import ARCHS, DTYPES, S, _np_params, _source, _tokens
from test_torch_train import _batch, _conditioning, _jax_grads, _max_rel, \
    _port_grads

# the archs this slice brought: MoE, hybrid mamba2 + shared attention,
# rwkv6, cross-attention over patches, the encoder-decoder
NEW = ("llama4-scout-17b-a16e", "mixtral-8x22b", "zamba2-7b", "rwkv6-1.6b",
       "llama-3.2-vision-90b", "whisper-large-v3")
FAMILY_ARCH = {"moe": "mixtral-8x22b", "hybrid": "zamba2-7b",
               "ssm": "rwkv6-1.6b", "vlm": "llama-3.2-vision-90b",
               "audio": "whisper-large-v3", "dense": "qwen3-14b"}


def _l2(want, got) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got.double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    return float(np.linalg.norm(want - got) / np.linalg.norm(want))


def _setup(arch, seq=S):
    """(cfg, numpy params, JAX params, port params, JAX batch, port batch),
    the weights at std 1/sqrt(fan-in) (``fan_in_scale``).  At the init's
    std 1/sqrt(groups) these configs are ill-conditioned: float32
    reordering alone moves zamba2's and llama-3.2-vision's hidden states by
    up to 3e-5 of max, the JAX package's own bf16 logits are up to 0.23
    from its f32 ones in L2, and some of zamba2's gradients are NaN in the
    JAX package (``test_mamba2_grads_finite_where_the_reference_overflows``);
    ``tests/test_torch_lm.py`` holds the logits at that draw."""
    cfg = registry.smoke_config(arch)
    p = fan_in_scale(cfg, _np_params(cfg))
    jb, tb = _batch(cfg, s=seq)
    src = _source(cfg, tb["tokens"].shape[0])
    jb.update(src)
    tb.update({k: torch.from_numpy(v) for k, v in src.items()})
    return (cfg, p, jax.tree.map(jnp.asarray, p),
            lm_params_from_reference(p, "cpu"),
            jax.tree.map(jnp.asarray, jb), tb)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, dt):
    """The hidden state within 1e-5 of max (f32) or 2e-2 relative L2
    (bf16); aux (the MoE load-balance loss summed over slots and groups)
    within 1e-6 (f32) or 2e-2 relative (bf16); ``loss_fn``'s total and
    parts within 1e-5 (f32) or 5e-3 (bf16) relative."""
    jdt, tdt = DTYPES[dt]
    cfg, _, jm, tm, jb, tb = _setup(arch)
    jh, jaux, _ = JM.forward(cfg, jm, jb, dtype=jdt)
    th, taux, tc = TM.forward(cfg, tm, tb, dtype=tdt)
    assert tc is None and th.dtype == tdt and taux.dtype == torch.float32
    if dt == "f32":
        err = float(np.abs(np.asarray(jh) - th.numpy()).max()
                    / np.abs(np.asarray(jh)).max())
        assert err <= 1e-5, err
        assert abs(float(jaux) - float(taux)) <= 1e-6
    else:
        assert _l2(np.asarray(jh, np.float32), th) <= 2e-2
        assert abs(float(jaux) - float(taux)) <= 2e-2 * abs(float(jaux))
    assert (float(taux) > 0) == (cfg.moe is not None)
    jt, jmet = JM.loss_fn(cfg, jm, jb, dtype=jdt)
    with torch.no_grad():
        tt, tmet = TM.loss_fn(cfg, tm, tb, dtype=tdt)
    tol = 1e-5 if dt == "f32" else 5e-3
    for j, t in ((jt, tt), (jmet["loss"], tmet["loss"]),
                 (jmet["aux_loss"], tmet["aux_loss"])):
        assert abs(float(j) - float(t)) <= tol * max(abs(float(j)), 1e-3)
    assert float(tt) == pytest.approx(
        float(tmet["loss"]) + TM.AUX_LOSS_WEIGHT * float(tmet["aux_loss"]))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_caches_match_reference(arch, dt):
    """Every cache leaf ``prefill`` emits has the JAX package's shape and
    dtype (recurrent states float32, the rest the compute dtype) and its
    values within 1e-5 (f32) or 2e-2 relative L2 (bf16); the cache
    converted from the JAX prefill's has the same dtypes; ``decode_step``
    updates it in place to the JAX step's new cache.  ``init_cache`` gives
    the same shapes and dtypes."""
    jdt, tdt = DTYPES[dt]
    cfg, _, jm, tm, jb, tb = _setup(arch)
    jb = {k: v for k, v in jb.items() if k != "labels"}
    tb = {k: v for k, v in tb.items() if k != "labels"}
    _, jc, jpos = JM.prefill(cfg, jm, jb, max_cache_len=S + 3, dtype=jdt)
    _, tc, tpos = TM.prefill(cfg, tm, tb, max_cache_len=S + 3, dtype=tdt)
    conv = lm_cache_from_reference(jax.tree.map(np.asarray, jc), "cpu")
    zero = TM.init_cache(cfg, tb["tokens"].shape[0], S + 3, tdt)
    want = dict(tree_leaves(jc))
    assert sorted(want) == [p for p, _ in tree_leaves(tc)]

    def check(path, j, t):
        assert t.dtype == (torch.float32 if j.dtype == jnp.float32 else tdt)
        assert tuple(t.shape) == j.shape, path
        if dt == "f32":
            assert _max_rel(j, t) <= 1e-5, path
        else:
            assert _l2(np.asarray(j, np.float32), t) <= 2e-2, path

    for path, t in tree_leaves(tc):
        check(path, want[path], t)
        assert _leaf(conv, path).dtype == t.dtype
        z = _leaf(zero, path)
        assert z.dtype == t.dtype and z.shape == t.shape
    tok = _tokens(cfg, 1, seed=300)
    _, jnew = JM.decode_step(cfg, jm, jc, jnp.asarray(tok), jpos, dtype=jdt)
    _, same = TM.decode_step(cfg, tm, tc, torch.from_numpy(tok).long(), tpos,
                             dtype=tdt)
    assert same is tc
    for path, j in tree_leaves(jnew):
        check(path, j, _leaf(tc, path))


def _leaf(tree, path):
    """The leaf of a nested dict at a ``tree_leaves`` path."""
    for k in path[2:-2].split("']['"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", NEW)
def test_grads_match_reference_f32(arch):
    """Each gradient leaf of ``loss_fn`` (MoE aux included) within 1e-4 of
    its max|g|, or within 4x the leaf's float32 floor at these inputs where
    that is larger (``tests/test_torch_train.py`` ``_conditioning``), with
    remat active; the loss within 1e-5 relative."""
    cfg, p, _, tm, jb, tb = _setup(arch)
    jl, jg = _jax_grads(cfg, p, jax.tree.map(np.asarray, jb), jnp.float32)
    tl, tg = _port_grads(cfg, tm, tb, torch.float32)
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    floor = _conditioning(cfg, p, tb, tg)
    for (path, a), (_, b) in zip(tree_leaves(jg), tree_leaves(tg)):
        assert b.dtype == torch.float32 and bool(torch.isfinite(b).all())
        assert _max_rel(a, b) <= max(1e-4, 4 * floor[path]), \
            (path, _max_rel(a, b), floor[path])


def test_mamba2_grads_finite_where_the_reference_overflows():
    """At the init's std 1/sqrt(groups) (and a_log, dt_bias drawn
    non-zero), zamba2's smoke config has SSD decays exp(L_t - L_s) above
    the causal diagonal that overflow float32.  The JAX function takes exp
    before masking them, so its gradient is 0 * inf = NaN there; the port
    masks first: its loss equals the JAX package's and every gradient leaf
    is finite."""
    cfg = registry.smoke_config("zamba2-7b")
    p = _np_params(cfg)
    jb, tb = _batch(cfg)
    jl, jg = _jax_grads(cfg, p, jb, jnp.float32)
    tl, tg = _port_grads(cfg, lm_params_from_reference(p, "cpu"), tb,
                         torch.float32)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert not all(np.isfinite(a).all() for _, a in tree_leaves(jg))
    assert all(bool(torch.isfinite(g).all()) for _, g in tree_leaves(tg))


@pytest.mark.parametrize("arch,calls", [
    ("llama-3.2-vision-90b", 10 + 1),   # period 5 > 4: each of 10 slots
    ("whisper-large-v3", 2 + 2 + 1),    # 2 encoder layers, 2 groups
    ("zamba2-7b", 2 + 1)])              # period 3: each of 2 groups
def test_remat_follows_the_reference(monkeypatch, arch, calls):
    """Checkpointed regions of the new archs where autograd records: each
    slot when the period is above 4, else each group, each encoder layer,
    one a cross-entropy chunk; rwkv6's recurrence one a 64-step chunk.
    None under no_grad."""
    cfg, _, _, tm, _, tb = _setup(arch)
    seen = []
    real = TM.checkpoint

    def counting(fn, *args, **kw):
        seen.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(TM, "checkpoint", counting)
    _port_grads(cfg, tm, tb, torch.float32)
    assert len(seen) == calls and seen[-1] == "_xent_chunk", seen
    seen.clear()
    with torch.no_grad():
        TM.loss_fn(cfg, tm, tb, dtype=torch.float32)
    assert seen == []
    monkeypatch.setattr(TRW, "checkpoint", counting)
    r = torch.randn(1, 130, 2, 4, requires_grad=True)
    with torch.enable_grad():
        y, _ = TRW.wkv_scan(r, r, r, -torch.ones(1, 130, 2, 4),
                            torch.zeros(2, 4), chunk=65)
    assert seen == ["_wkv_chunk"] * 2 and y.requires_grad


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_serve_and_train_cli_cpu_smoke(family, capsys, tmp_path):
    """``launch.serve`` and ``launch.train --smoke`` on the CPU for one arch
    of each family, in this process."""
    arch = FAMILY_ARCH[family]
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen",
                       "4"]) == 0
    out = capsys.readouterr().out
    assert f"{registry.smoke_config(arch).name} on cpu: prefill 2x8" in out
    rc = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--steps", "3", "--batch", "2", "--seq", "8",
                     "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert rc in (0, 2) and "done: 3 steps" in out, out


def test_generate_takes_the_cross_source():
    """whisper's frames reach the prefill: other frames, other ids."""
    cfg = registry.smoke_config("whisper-large-v3")
    params = TM.init(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, 6)).long()
    src = {k: torch.from_numpy(v) for k, v in _source(cfg, 2).items()}
    ids, _, _ = serve.generate(cfg, params, toks, 4,
                               generator=torch.Generator(), source=src)
    logits, _, _ = TM.prefill(cfg, params, {"tokens": toks, **src},
                              dtype=torch.float32)
    assert torch.equal(ids[:, 0], logits.argmax(-1).to(torch.int32))
    other = {k: 10 * v for k, v in src.items()}
    logits2, _, _ = TM.prefill(cfg, params, {"tokens": toks, **other},
                               dtype=torch.float32)
    assert not torch.allclose(logits, logits2)
    with pytest.raises(KeyError, match="frames"):
        serve.generate(cfg, params, toks, 2, generator=torch.Generator())

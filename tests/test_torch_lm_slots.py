"""The port's LM slot modules against the JAX package's on the same inputs,
made with numpy from a seed: the MoE FFN (its dispatch exactly: the
selected experts, the kept and dropped pairs), the Mamba2 SSD scan and
block, the RWKV6 recurrence and mixes, cross-attention decode, the
encoder, WLSH kernel attention, and ``launch.specs``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import MoESpec, SHAPES
from repro.core import get_bucket_fn as jax_bucket_fn
from repro.launch import specs as JS
from repro.models import attention as JA
from repro.models import mamba2 as JM2
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import rwkv6 as JRW
from repro.models import wlsh_attention as JW
from repro_torch.configs import registry
from repro_torch.convert import wlsh_attn_from_reference
from repro_torch.core import GammaPDF, WLSHKernelSpec, get_bucket_fn, \
    make_wlsh_kernel
from repro_torch.launch import specs as TS
from repro_torch.models import attention as TA
from repro_torch.models import mamba2 as TM2
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import rwkv6 as TRW
from repro_torch.models import wlsh_attention as TW
from repro_torch.models.params import tree_leaves, tree_map

from test_torch_lm import _np_params

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rel(want, got) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-12))


def _both(a, dt="f32"):
    jdt, tdt = DTYPES[dt]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _trees(p, dt="f32"):
    jdt, tdt = DTYPES[dt]
    return (jax.tree.map(lambda a: jnp.asarray(a, jdt), p),
            tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(tdt), p))


def _slot0(arch, key):
    """One layer's parameters of the smoke config's slot 0 (numpy)."""
    cfg = registry.smoke_config(arch)
    return cfg, tree_map(lambda a: a[0],
                         _np_params(cfg)["groups"]["slot0"][key])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(spec, d, seed=0):
    rng = np.random.default_rng(seed)
    p = {"router": 0.5 * rng.standard_normal((d, spec.n_experts)),
         "w_gate": rng.standard_normal((spec.n_experts, d, spec.d_ff)) / 4,
         "w_up": rng.standard_normal((spec.n_experts, d, spec.d_ff)) / 4,
         "w_down": rng.standard_normal((spec.n_experts, spec.d_ff, d)) / 6}
    # expert 0 favoured for the inputs' mean of 0.5, so a capacity factor
    # of 1.25 drops pairs
    p["router"][:, 0] += 1.0
    return tree_map(lambda a: a.astype(np.float32), p)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity", [1.25, 8.0])
def test_moe_ffn_matches_reference(capacity, top_k, dt):
    """The selected experts, and the stable-sort dispatch's kept and dropped
    (token, expert) pairs, equal the JAX function's, the gate weights to
    2e-6 relative (the softmax's rounding); outputs within 1e-5 (f32) or
    2e-2 (bf16) of max; aux to 1e-6."""
    b, s, d, e = 3, 40, 16, 4
    spec = MoESpec(n_experts=e, top_k=top_k, d_ff=24,
                   capacity_factor=capacity)
    p = _moe_params(spec, d)
    x = (0.5 + np.random.default_rng(1).standard_normal((b, s, d))).astype(
        np.float32)
    jp, tp = _trees(p, dt)
    jx, tx = _both(x, dt)
    cap = TMOE._capacity(s, spec)
    assert cap == JMOE._capacity(s, spec)

    jl = jnp.einsum("bsd,de->bse", jx.astype(jnp.float32),
                    jp["router"].astype(jnp.float32))
    tl = torch.einsum("bsd,de->bse", tx.float(), tp["router"].float())
    _, jidx = jax.lax.top_k(jax.nn.softmax(jl, -1), top_k)
    _, tidx = torch.topk(torch.softmax(tl, -1), top_k, dim=-1)
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    jmap, jw, jaux = jax.vmap(
        lambda lg: JMOE._dispatch_row(lg, e, top_k, cap))(jl)
    tmap, tw, taux = TMOE._dispatch_row(tl, e, top_k, cap)
    np.testing.assert_array_equal(np.asarray(jmap), tmap.numpy())
    np.testing.assert_allclose(np.asarray(jw), tw.numpy(), rtol=2e-6)
    kept = int((tmap < s).sum())
    if capacity == 8.0:
        assert kept == b * s * top_k
    else:
        assert kept < b * s * top_k          # some pairs dropped

    jy, ja = JMOE.moe_ffn(jp, jx, spec)
    ty, ta = TMOE.moe_ffn(tp, tx, spec)
    assert ty.dtype == DTYPES[dt][1] and ta.dtype == torch.float32
    assert _rel(jy, ty) <= (1e-5 if dt == "f32" else 2e-2)
    assert abs(float(ja) - float(ta)) <= 1e-6
    assert float(ta) == pytest.approx(float(taux.mean()))


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def _ssd_inputs(b=2, s=256, h=3, p=8, n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    bm = rng.standard_normal((b, s, n))
    cm = rng.standard_normal((b, s, n))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
    a = -np.exp(0.5 * rng.standard_normal(h))
    h0 = rng.standard_normal((b, h, p, n))
    return [np.asarray(v, np.float32) for v in (x, bm, cm, dt, a, h0)]


@pytest.mark.parametrize("chunk", [64, 256])
def test_ssd_chunked_matches_reference_and_sequential(chunk):
    args = _ssd_inputs()
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    jy, jh = JM2.ssd_chunked(*jargs[:5], h0=jargs[5], chunk=chunk)
    ty, th = TM2.ssd_chunked(*targs[:5], h0=targs[5], chunk=chunk)
    assert ty.dtype == th.dtype == torch.float32
    assert _rel(jy, ty) <= 1e-5 and _rel(jh, th) <= 1e-5
    ry, rh = TM2.mamba2_ref_scan(*targs[:5], h0=targs[5])
    jry, jrh = JM2.mamba2_ref_scan(*jargs[:5], h0=jargs[5])
    assert _rel(jry, ry) <= 1e-5 and _rel(jrh, rh) <= 1e-5
    assert _rel(ry, ty) <= 1e-4 and _rel(rh, th) <= 1e-4
    with pytest.raises(ValueError, match="not divisible"):
        TM2.ssd_chunked(*(t[:, :100] if t.ndim > 1 else t
                          for t in targs[:5]), chunk=64)


def test_ssd_decode_step_matches_reference():
    x, bm, cm, dt, a, h0 = _ssd_inputs(s=1)
    j = JM2.ssd_decode_step(jnp.asarray(h0), jnp.asarray(x[:, 0]),
                            jnp.asarray(bm[:, 0]), jnp.asarray(cm[:, 0]),
                            jnp.asarray(dt[:, 0]), jnp.asarray(a))
    t = TM2.ssd_decode_step(torch.from_numpy(h0), torch.from_numpy(x[:, 0]),
                            torch.from_numpy(bm[:, 0]),
                            torch.from_numpy(cm[:, 0]),
                            torch.from_numpy(dt[:, 0]), torch.from_numpy(a))
    assert _rel(j[0], t[0]) <= 1e-6 and _rel(j[1], t[1]) <= 1e-6


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mamba2_block_prefill_and_decode_match_reference(dt):
    """A prefill of 16 tokens, then one decode step from its states: the
    outputs and both states (conv in the compute dtype, ssm float32)."""
    cfg, p = _slot0("zamba2-7b", "mixer")
    jp, tp = _trees(p, dt)
    x = np.random.default_rng(2).standard_normal((2, 17, cfg.d_model))
    jx, tx = _both(x, dt)
    tol = 1e-5 if dt == "f32" else 2e-2
    jy, (jc, js) = JM2.mamba2_block(jp, jx[:, :16], cfg.ssm)
    ty, (tc, ts) = TM2.mamba2_block(tp, tx[:, :16], cfg.ssm)
    assert tc.dtype == DTYPES[dt][1] and ts.dtype == torch.float32
    assert str(jc.dtype) == str(tc.dtype).split(".")[-1]
    for j, t in ((jy, ty), (jc, tc), (js, ts)):
        assert _rel(j, t) <= tol
    jy, (jc2, js2) = JM2.mamba2_block(jp, jx[:, 16:], cfg.ssm,
                                      conv_state=jc, ssm_state=js,
                                      decode=True)
    ty, (tc2, ts2) = TM2.mamba2_block(tp, tx[:, 16:], cfg.ssm,
                                      conv_state=tc, ssm_state=ts,
                                      decode=True)
    for j, t in ((jy, ty), (jc2, tc2), (js2, ts2)):
        assert _rel(j, t) <= tol
    assert TM2._softplus(torch.tensor([30.0, -30.0, 0.5])).tolist() == \
        pytest.approx(np.asarray(jax.nn.softplus(
            jnp.array([30.0, -30.0, 0.5]))).tolist(), rel=1e-7)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _wkv_inputs(b=2, s=48, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, d)) for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, s, h, d)))
    u = rng.standard_normal((h, d))
    s0 = rng.standard_normal((b, h, d, d))
    return [np.asarray(a, np.float32) for a in (r, k, v, logw, u, s0)]


@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv_scan_and_step_match_reference(chunk):
    """wkv_scan (several chunks, and one where S is not a multiple of the
    chunk) against the JAX scan and the port's step loop; remat under
    autograd gives the plain loop's values and gradient."""
    args = _wkv_inputs()
    jy, js = JRW.wkv_scan(*(jnp.asarray(a) for a in args[:5]),
                          s0=jnp.asarray(args[5]), chunk=chunk)
    targs = [torch.from_numpy(a) for a in args]
    ty, ts = TRW.wkv_scan(*targs[:5], s0=targs[5], chunk=chunk)
    assert _rel(jy, ty) <= 1e-5 and _rel(js, ts) <= 1e-5
    st, ys = targs[5], []
    for t in range(targs[0].shape[1]):
        y, st = TRW.wkv_step(st, *(a[:, t] for a in targs[:4]), targs[4])
        ys.append(y)
    jst = JRW.wkv_step(jnp.asarray(args[5]), *(jnp.asarray(a[:, 0])
                                               for a in args[:4]),
                       jnp.asarray(args[4]))
    tst = TRW.wkv_step(targs[5], *(a[:, 0] for a in targs[:4]), targs[4])
    assert _rel(jst[0], tst[0]) <= 1e-6 and _rel(jst[1], tst[1]) <= 1e-6
    assert torch.equal(torch.stack(ys, 1), ty) and torch.equal(st, ts)
    wgt = torch.from_numpy(np.random.default_rng(9).standard_normal(
        ty.shape).astype(np.float32))
    grads = []
    for remat in (True, False):
        k = targs[1].clone().requires_grad_(True)
        with torch.enable_grad():
            if remat:
                yg, _ = TRW.wkv_scan(targs[0], k, *targs[2:5], s0=targs[5],
                                     chunk=chunk)
            else:
                st, ys = targs[5], []
                for t in range(k.shape[1]):
                    y, st = TRW.wkv_step(st, targs[0][:, t], k[:, t],
                                         targs[2][:, t], targs[3][:, t],
                                         targs[4])
                    ys.append(y)
                yg = torch.stack(ys, 1)
            (yg * wgt).sum().backward()
        assert torch.equal(yg.detach(), ty)
        grads.append(k.grad)
    assert _rel(grads[1], grads[0]) <= 1e-6


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_time_mix_and_channel_mix_match_reference(dt):
    """Prefill of 16 tokens, then a decode step from its states; the group
    norm's population variance, the token shift from the carried rows."""
    cfg, p = _slot0("rwkv6-1.6b", "mixer")
    jp, tp = _trees(p, dt)
    x = np.random.default_rng(3).standard_normal((2, 17, cfg.d_model))
    jx, tx = _both(x, dt)
    tol = 1e-5 if dt == "f32" else 2e-2
    jy, (jsh, jwkv) = JRW.time_mix(jp, jx[:, :16])
    ty, (tsh, twkv) = TRW.time_mix(tp, tx[:, :16])
    assert tsh.dtype == twkv.dtype == torch.float32
    for j, t in ((jy, ty), (jsh, tsh), (jwkv, twkv)):
        assert _rel(j, t) <= tol
    jy2, (_, jwkv2) = JRW.time_mix(jp, jx[:, 16:], shift_state=jsh,
                                   wkv_state=jwkv, decode=True)
    ty2, (_, twkv2) = TRW.time_mix(tp, tx[:, 16:], shift_state=tsh,
                                   wkv_state=twkv, decode=True)
    assert _rel(jy2, ty2) <= tol and _rel(jwkv2, twkv2) <= tol
    jc, jcs = JRW.channel_mix(jp, jx[:, :16])
    tc, tcs = TRW.channel_mix(tp, tx[:, :16])
    assert _rel(jc, tc) <= tol and _rel(jcs, tcs) == 0.0
    jc2, _ = JRW.channel_mix(jp, jx[:, 16:], shift_state=jcs)
    tc2, _ = TRW.channel_mix(tp, tx[:, 16:], shift_state=tcs)
    assert _rel(jc2, tc2) <= tol
    y = np.random.default_rng(4).standard_normal((2, 3, 4, 8))
    assert _rel(JRW._group_norm(jnp.asarray(y, jnp.float32),
                                jnp.ones((4, 8))),
                TRW._group_norm(torch.from_numpy(y).float(),
                                torch.ones(4, 8))) <= 1e-6


# ---------------------------------------------------------------------------
# cross-attention and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-90b"])
def test_cross_decode_attention_matches_reference(arch):
    """Against the JAX function's unmasked softmax over every source row
    (B9's plain version on the CPU)."""
    cfg = registry.smoke_config(arch)
    i = next(j for j, s in enumerate(cfg.layer_pattern) if s.cross_attn)
    p = tree_map(lambda a: a[0],
                 _np_params(cfg)["groups"][f"slot{i}"]["cross_attn"])
    jp, tp = _trees(p)
    rng = np.random.default_rng(5)
    l = cfg.cross_attn_source_len
    x = rng.standard_normal((3, 1, cfg.d_model))
    ck = rng.standard_normal((3, l, cfg.n_kv_heads, cfg.head_dim))
    cv = rng.standard_normal(ck.shape)
    (jx, tx), (jk, tk), (jv, tv) = _both(x), _both(ck), _both(cv)
    jy = JA.cross_decode_attention(jp, jx, jk, jv)
    ty = TA.cross_decode_attention(tp, tx, tk, tv)
    assert _rel(jy, ty) <= 1e-5
    assert torch.equal(tk, torch.from_numpy(ck.astype(np.float32)))


def test_encode_matches_reference():
    cfg = registry.smoke_config("whisper-large-v3")
    p = _np_params(cfg)
    jp, tp = _trees(p)
    frames = 0.1 * np.random.default_rng(6).standard_normal(
        (2, cfg.encoder.n_frames, cfg.d_model))
    jf, tf = _both(frames)
    assert _rel(JM._encode(cfg, jp, jf), TM._encode(cfg, tp, tf)) <= 1e-5


# ---------------------------------------------------------------------------
# WLSH kernel attention
# ---------------------------------------------------------------------------

def test_wlsh_attention_matches_reference():
    """Slots bitwise and weights to 1e-6 under the JAX package's instances,
    the output within 1e-5 of max|out|; and the JAX test's check against
    the explicit kernel attention with the analytic kernel."""
    rng = np.random.default_rng(7)
    b, s, h, d, dv = 2, 32, 2, 16, 8
    q = (0.5 * rng.standard_normal((b, s, h, d))).astype(np.float32)
    k = (0.5 * rng.standard_normal((b, s, h, d))).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    jparams = JW.sample_wlsh_attn(jax.random.PRNGKey(3), m=3000, d_head=d,
                                  d_hash=2, lengthscale=2.0)
    tparams = wlsh_attn_from_reference(jparams, "cpu")
    jf, tf = jax_bucket_fn("rect"), get_bucket_fn("rect")
    qf = q.transpose(0, 2, 1, 3).reshape(b * h, s, d)
    js, jw = JW._hash_weight(jnp.asarray(qf), jparams, jf, 512)
    ts, tw = TW._hash_weight(torch.from_numpy(qf), tparams, tf, 512)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert _rel(jw, tw) <= 1e-6
    jout = JW.wlsh_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jparams, jf, table_size=512)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tout = TW.wlsh_attention(tq, tk, tv, tparams, tf, table_size=512)
    assert tout.shape == (b, s, h, dv) and _rel(jout, tout) <= 1e-5
    kern = make_wlsh_kernel(WLSHKernelSpec(bucket=tf, pdf=GammaPDF(2.0, 1.0),
                                           lengthscale=2.0))
    oracle = TW.kernel_attention_oracle(tq, tk, tv, kern.k1d, tparams)
    assert _rel(oracle, tout) < 0.05
    with pytest.raises(ValueError, match="power of two"):
        TW.wlsh_attention(tq, tk, tv, tparams, tf, table_size=500)


def test_sample_wlsh_attn_is_seeded_and_shaped():
    a = TW.sample_wlsh_attn(np.random.default_rng(1), 5, 16, device="cpu")
    b = TW.sample_wlsh_attn(np.random.default_rng(1), 5, 16, device="cpu")
    assert a.proj.shape == (5, 16, 4) and a.r1.dtype == torch.uint32
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert bool((a.z >= 0).all() & (a.z <= a.w).all())
    assert bool(((a.r1.to(torch.int64) & 1) == 1).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TW.sample_wlsh_attn(np.random.default_rng(1), 5, 16)


# ---------------------------------------------------------------------------
# launch/specs.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_specs_match_reference(arch):
    """useful_flops and matmul_params equal the JAX package's for every
    shape cell at the full config; batch_specs' and decode_specs' shapes
    and dtypes (the cache's float32 states as the port's prefill emits
    them) at a reduced shape."""
    cfg = registry.get_config(arch)
    jcfg = jax_registry.get_config(arch)
    assert TS.matmul_params(cfg) == JS.matmul_params(jcfg)
    for name, shape in SHAPES.items():
        assert TS.useful_flops(cfg, shape) == JS.useful_flops(jcfg, shape), \
            name
    small = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=2)
    for kind in ("train", "prefill"):
        sh = dataclasses.replace(small, kind=kind)
        ours = TS.batch_specs(cfg, sh)
        theirs = JS.batch_specs(jcfg, sh)
        assert sorted(ours) == sorted(theirs)
        for k, t in ours.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == theirs[k].shape
            assert str(t.dtype).split(".")[-1] == str(theirs[k].dtype)
    cache, tok, pos = TS.decode_specs(cfg, small)
    jcache, jtok, jpos = JS.decode_specs(jcfg, small)
    assert tuple(tok.shape) == jtok.shape and tuple(pos.shape) == jpos.shape
    jleaves = dict(jax.tree_util.tree_flatten_with_path(jcache)[0])
    jshapes = {jax.tree_util.keystr(p): s.shape for p, s in jleaves.items()}
    assert {p: tuple(t.shape) for p, t in tree_leaves(cache)} == jshapes
    for p, t in tree_leaves(cache):
        want = torch.float32 if p.split("'")[-2] in TM.F32_STATES \
            else torch.bfloat16
        assert t.dtype == want and t.device.type == "meta", p


def test_useful_flops_counts_the_encoder_and_the_experts():
    """whisper's encoder term and mixtral's top-2 of 8 experts, by hand.
    The encoder's parameters are also matmul parameters of the model, so
    (as in the JAX formula) they count once a decoder token too."""
    cfg = registry.get_config("mixtral-8x22b")
    active, total = TS.matmul_params(cfg)
    experts = 3 * cfg.moe.n_experts * cfg.d_model * cfg.moe.d_ff * \
        cfg.n_layers
    assert total - active == experts - experts * 2 // 8
    w = registry.get_config("whisper-large-v3")
    pre = dataclasses.replace(SHAPES["prefill_32k"], seq_len=448,
                              global_batch=8)
    no_enc = dataclasses.replace(w, encoder=None, cross_attn_source_len=1500)
    enc = TS._encoder_params(w)
    assert enc == 32 * (4 * 1280 * 1280 + 3 * 1280 * 5120)
    assert TS.useful_flops(w, pre) - TS.useful_flops(no_enc, pre) == \
        pytest.approx(2.0 * enc * 8 * (1500 + 448), rel=1e-12)

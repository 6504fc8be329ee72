"""The LM stack of every registry arch served on a (data, model) grid of
``torch.distributed`` ranks, laid out by the JAX package's sharding rules
(``repro_torch.sharding``): the counterpart of the JAX package's prefill
and decode steps compiled with ``param_shardings`` / ``cache_shardings`` on
a mesh.

Every rank holds its block of each parameter (``convert.local_lm_params``,
or ``checkpoint.restore_resharded`` by ``launch.specs.param_shardings``) and
of each cache leaf.  The contract:

* **Batch over ``data``.**  A data rank runs its rows of the batch (all of
  them where the batch does not divide the data axis): tokens, positions,
  the cross-attention source (whisper's ``frames``, a VLM's ``patches``)
  and the batch dim of every cache leaf.
* **Compute dims stay sharded** where the rules give them ``model``,
  decided for each slot from its own leaves (``GridLayout``):

  - attention (a decoder slot's, the shared block, cross attention, the
    encoder's): ``wq``/``wk``/``wv`` column-parallel over ``heads`` /
    ``kv_heads``, ``wo`` row-parallel;
  - the MLP: ``w_gate``/``w_up`` column-parallel over ``mlp``, ``w_down``
    row-parallel;
  - MoE: where ``experts`` takes ``model`` a rank holds experts [r E/M,
    (r+1) E/M); it runs the float32 router and the dispatch for all its
    rows, as every model rank does, and gathers, multiplies and combines
    the pairs of its own experts (``moe.moe_ffn(experts=)``).  Where
    ``experts`` falls through to ``mlp``, every expert is column-parallel
    in ``mlp`` and row-parallel in ``w_down``;
  - mamba2 on ``ssm_heads``: ``in_proj`` is column-parallel on its stored
    block (contiguous columns of z | xBC | dt, which do not line up with
    the heads) and its output is all-gathered over ``model``; the rank
    takes its heads' z, x and dt and the whole B and C, runs the causal
    conv whole (``conv_w``, ``conv_b`` and the ``conv`` cache are gathered
    at use), the SSD scan on its heads, the gated norm over the whole
    d_inner from an all-reduced sum of squares, and ``out_proj``
    row-parallel;
  - rwkv6 on ``heads``: ``w_r``/``w_k``/``w_v``, ``w0``, ``w_lora_b``,
    ``u_bonus``, ``ln_x`` and the ``wkv`` state are the rank's heads,
    ``w_g``'s ``mlp`` columns its heads' (checked), ``w_o`` row-parallel;
    the channel mix's ``w_ck``/``w_cv`` are an MLP whose all-reduced
    product the gate sigmoid(x ``w_cr``), computed whole, multiplies;
  - the embedding is vocab-parallel (a masked lookup of the rank's vocab
    range, then an all-reduce over ``model``; whisper's sinusoidal
    positions are added after it), and the logits stay vocab-sharded:
    ``argmax`` is a cross-rank argmax that returns ``torch.argmax``'s
    answer on the gathered logits.

  A row-parallel product is summed by one all-reduce over the model group.
  Where the rules leave a compute dim replicated over a model group of
  more than one rank, every rank computes it whole and nothing is summed.
  Collectives always run: on a one-rank model group the all-reduces run
  as on a larger one.
* **Every other sharded dim is gathered at use** (``sharding.
  gather_at_use``): ``embed`` over ``data`` (the FSDP rule), ``head_dim``
  over ``model`` where ``heads`` or ``kv_heads`` does not divide, mamba2's
  conv leaves; each group's weights as the group runs, freed after it; the
  shared attention block once a pass.
* **The cache stays stored by the rules** (``cache_shardings``): a cache dim
  on ``head_dim``, ``seq_shard`` or mamba2's conv channels is gathered at
  use, and the rank's block of the written cache is copied back; the
  cross-attention keys and values, written by the prefill from the rank's
  kv heads, are only read.
* **GQA on local heads.**  A rank's query heads [r H/M, (r+1) H/M) read kv
  heads h // (H/KV).  Where ``kv_heads`` is sharded too, those are the
  rank's own kv heads; else the rank computes every kv head (its cache
  keeps them all) and attends over the ones its query heads read
  (``Attn.kv_index``): one kv head for all of them, or one a query head.
  B9 runs at the local (B/data, KV_local, G_local, D).
* **Training** (``loss_fn``; ``launch.steps.make_train_step(mesh=)``).
  Where autograd records, every collective above is the autograd-visible
  one of ``repro_torch.sharding`` (its backward the adjoint: all-reduce for
  an all-reduce, reduce-scatter for an all-gather), and the stack is
  rematerialized as ``model._backbone_full``'s: each slot when the
  pattern's period is above 4, else each group; each encoder layer; each
  cross-entropy chunk.  A group's (or a slot's) weights are gathered
  INSIDE its checkpointed function, so the recompute gathers them again and
  no gathered weight lives until the backward.  The carry between groups is
  cut to the rank's sequence block (``act_seq`` on 'model', where the
  sequence divides) and gathered again at the next group's start: each
  group checkpoint keeps (B_local, S/M, D).  The cross-entropy is
  vocab-parallel: each rank's logits are its vocab block's, the
  log-sum-exp and the gold logit summed over 'model', never the (B, C, V)
  logits gathered.  ``loss_fn`` returns the global loss on every rank, with
  the rank's share of it as what its backward differentiates.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ModelConfig
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..sharding import (all_gather_dim, all_reduce_, entry_parts,
                        gather_at_use, gather_dim, keep_block, local_block,
                        local_shape, reduce_sum, spec_for, tree_shardings)
from . import mamba2 as m2
from . import rwkv6 as rw
from .attention import (cross_decode_attention, decode_attention,
                        multihead_attention)
from .layers import mlp, rmsnorm, sinusoidal_positions
from .moe import moe_ffn
from .params import tree_map

Tensor = torch.Tensor

# logical axes a rank keeps sharded over 'model' through its computation
# (unless its slot's layout gathers a leaf: mamba2's conv leaves, and the
# leaves that line up with the heads where the heads are not on 'model')
COMPUTE_AXES = frozenset({"heads", "kv_heads", "mlp", "vocab", "experts",
                          "ssm_heads"})
NOTHING_KEPT = frozenset()
# cache leaves the prefill writes and decode only reads
READ_ONLY = frozenset({"cross_k", "cross_v"})


def _gathered(axes, spec, keep) -> list[int]:
    """The dims of a leaf gathered at use: sharded, and neither a batch's
    rows nor a compute axis of ``keep`` on 'model'."""
    return [i for i, (a, e) in enumerate(zip(axes, spec))
            if e is not None and a != "batch"
            and not (a in keep and e == "model")]


def _gather_tree(axes, spec, keep, path=()):
    """{leaf: its gathered dims} over an axes tree; ``keep(path)`` names
    the compute axes a leaf keeps."""
    if isinstance(axes, dict):
        return {k: _gather_tree(axes[k], spec[k], keep, path + (k,))
                for k in axes}
    return _gathered(axes, spec, keep(path))


def _in_group(dims) -> list[int]:
    """A stacked leaf's gathered dims in one group's slice of it (the
    group axis, dim 0, is never sharded)."""
    return [i - 1 for i in dims]


def _on_model(axes, spec, name: str) -> bool:
    return any(a == name and e == "model" for a, e in zip(axes, spec))


class Attn(NamedTuple):
    """One attention parameter set on the grid: whether its ``wo`` product
    is summed over 'model', and the kv heads its local query heads read
    (indices into the kv heads it computes; None: its own)."""
    reduce: bool
    kv_index: Tensor | None


class Ffn(NamedTuple):
    """An MLP or MoE: whether its ``w_down`` product is summed over
    'model', and the rank's experts [lo, hi) where 'experts' is on 'model'
    (None: it holds every expert)."""
    reduce: bool
    experts: tuple[int, int] | None


class Mamba(NamedTuple):
    """A mamba2 mixer: the rank's ssm heads [lo, hi); whether they are its
    own (``ssm_heads`` on 'model', or a one-rank group: ``norm_scale`` and
    ``out_proj`` are their blocks, the norm's sum of squares and the
    ``out_proj`` product summed over 'model'); whether ``in_proj``'s
    output is all-gathered (its columns on 'model')."""
    heads: tuple[int, int]
    local: bool
    gather_proj: bool


class Rwkv(NamedTuple):
    """An rwkv6 mixer: whether the time mix's ``w_o`` product (its heads on
    'model') and the channel mix's ``w_cv`` product (``mlp`` on 'model')
    are summed over 'model'."""
    reduce_time: bool
    reduce_channel: bool


def _attn_plan(ax: dict, sp: dict, cfg: ModelConfig, mesh) -> Attn:
    heads_on = _on_model(ax["wq"], sp["wq"], "heads")
    kv_on = _on_model(ax["wk"], sp["wk"], "kv_heads")
    kv_index = None
    if heads_on and not kv_on:
        hl = cfg.n_heads // mesh.model
        g = cfg.n_heads // cfg.n_kv_heads
        first = mesh.model_rank * hl
        idx = torch.arange(first, first + hl) // g
        if bool((idx == idx[0]).all()):
            idx = idx[:1]
        kv_index = idx.to(mesh.device)
    return Attn(heads_on or mesh.model == 1, kv_index)


def _ffn_plan(ax: dict, sp: dict, cfg: ModelConfig, mesh) -> Ffn:
    experts = None
    if _on_model(ax["w_gate"], sp["w_gate"], "experts"):
        per = cfg.moe.n_experts // mesh.model
        experts = (mesh.model_rank * per, (mesh.model_rank + 1) * per)
    mlp_on = _on_model(ax["w_gate"], sp["w_gate"], "mlp")
    return Ffn(mlp_on or experts is not None or mesh.model == 1, experts)


def _mamba_plan(ax: dict, sp: dict, cfg: ModelConfig, mesh) -> Mamba:
    dims = m2.mamba2_dims(cfg.d_model, cfg.ssm)
    local = mesh.model == 1 or _on_model(ax["a_log"], sp["a_log"],
                                         "ssm_heads")
    hl = dims.n_heads // mesh.model if local else dims.n_heads
    lo = mesh.model_rank * hl if local else 0
    if local and mesh.model > 1:
        # the rank's heads' channels [lo P, hi P) of d_inner are its blocks
        # of norm_scale and of out_proj's rows
        for name in ("norm_scale", "out_proj"):
            if not _on_model(ax[name], sp[name], "mlp"):
                raise ValueError(f"mamba2 {name} {sp[name]}: d_inner is not "
                                 f"on 'model' with ssm_heads {sp['a_log']}")
    return Mamba((lo, lo + hl), local,
                 _on_model(ax["in_proj"], sp["in_proj"], "mlp"))


def _rwkv_plan(ax: dict, sp: dict, cfg: ModelConfig, mesh) -> Rwkv:
    heads_on = _on_model(ax["w_r"], sp["w_r"], "heads")
    if heads_on:
        # w_g's columns are H x head_dim, heads-major: a contiguous block of
        # them is the rank's heads' only where 'mlp' is cut like 'heads'
        shape = (cfg.d_model, cfg.n_heads * cfg.head_dim)
        cols = local_shape(shape, sp["w_g"][1:], mesh)[1]
        if not _on_model(ax["w_g"], sp["w_g"], "mlp") or \
                cols != cfg.n_heads // mesh.model * cfg.head_dim:
            raise ValueError(f"rwkv6 w_g {sp['w_g']} does not line up with "
                             f"the heads {sp['w_r']}")
    one = mesh.model == 1
    return Rwkv(heads_on or one,
                _on_model(ax["w_ck"], sp["w_ck"], "mlp") or one)


class ShardedCache(dict):
    """This rank's blocks of a decode cache (slot -> leaf -> tensor, the
    stacked group axis first, as ``model.init_cache``'s), with the global
    ``batch`` and ``seq_len`` its layout was cut for."""

    def __init__(self, blocks: dict, batch: int, seq_len: int):
        super().__init__(blocks)
        self.batch, self.seq_len = batch, seq_len


class GridLayout:
    """The layout of one config on one grid: the parameters' axes and
    specs, the dims each leaf gathers at use, and for each slot (``slots``,
    by pattern slot name; ``shared``, the shared attention block;
    ``encoder``, the encoder's layer) the plan of each of its parameter
    sets: ``Attn`` for ``attn`` and ``cross_attn``, ``Ffn`` for ``ffn``,
    ``Mamba`` or ``Rwkv`` for ``mixer``.  Build it once per (cfg, mesh) and
    pass it to ``prefill`` and ``decode_step``."""

    def __init__(self, cfg: ModelConfig, mesh):
        from .model import _use_rope, abstract_params, param_axes
        self.cfg, self.mesh = cfg, mesh
        self.axes = param_axes(cfg)
        self.spec = tree_shardings(self.axes, abstract_params(cfg), mesh)
        self._caches: dict = {}
        self.rope = cfg.rope_theta if _use_rope(cfg) else 0.0
        ax, sp = self.axes["groups"], self.spec["groups"]
        self.slots = {f"slot{i}": self._plans(s.kind, ax[f"slot{i}"],
                                              sp[f"slot{i}"])
                      for i, s in enumerate(cfg.layer_pattern)}
        self.shared = (_attn_plan(self.axes["shared"]["attn"],
                                  self.spec["shared"]["attn"], cfg, mesh)
                       if cfg.has_shared_attn else None)
        self.encoder = None
        if cfg.encoder is not None:
            self.encoder = self._plans(
                "attn", self.axes["encoder"]["groups"]["slot0"],
                self.spec["encoder"]["groups"]["slot0"])
        self.gather = _gather_tree(self.axes, self.spec, self._keep)
        self.vocab_on = _on_model(self.axes["embed"]["table"],
                                  self.spec["embed"]["table"], "vocab")
        self.reduce_embed = self.vocab_on or mesh.model == 1
        self.vocab_local = cfg.vocab_size // (mesh.model if self.vocab_on
                                              else 1)
        self.vocab_lo = mesh.model_rank * self.vocab_local \
            if self.vocab_on else 0

    def _plans(self, kind: str, ax: dict, sp: dict) -> dict:
        cfg, mesh = self.cfg, self.mesh
        plans = {name: _attn_plan(ax[name], sp[name], cfg, mesh)
                 for name in ("attn", "cross_attn") if name in ax}
        if "ffn" in ax:
            plans["ffn"] = _ffn_plan(ax["ffn"], sp["ffn"], cfg, mesh)
        if kind == "mamba2":
            plans["mixer"] = _mamba_plan(ax["mixer"], sp["mixer"], cfg, mesh)
        elif kind == "rwkv6":
            plans["mixer"] = _rwkv_plan(ax["mixer"], sp["mixer"], cfg, mesh)
        return plans

    def _keep(self, path) -> frozenset:
        """The compute axes a parameter leaf keeps as its block."""
        if len(path) < 4 or path[0] != "groups" or path[2] != "mixer":
            return COMPUTE_AXES
        plan, leaf = self.slots[path[1]]["mixer"], path[3]
        if isinstance(plan, Mamba):
            if leaf in ("conv_w", "conv_b") or (
                    leaf in ("norm_scale", "out_proj") and not plan.local):
                return NOTHING_KEPT
        elif leaf == "w_g" and not plan.reduce_time:
            return NOTHING_KEPT
        return COMPUTE_AXES

    # -- layouts ----------------------------------------------------------

    def rows_spec(self, batch: int, seq: int):
        """The spec of a (batch, seq) token array."""
        return spec_for(("batch", None), (batch, seq), self.mesh)

    def cache_layout(self, batch: int, seq_len: int):
        """(specs, gathered dims) trees of the decode cache of ``batch``
        rows and ``seq_len`` positions."""
        key = (batch, seq_len)
        if key not in self._caches:
            from .model import cache_axes, cache_specs
            axes = cache_axes(self.cfg, batch, seq_len)
            spec = tree_shardings(axes, cache_specs(self.cfg, batch,
                                                    seq_len), self.mesh)
            self._caches[key] = (spec, _gather_tree(
                axes, spec, lambda path: NOTHING_KEPT if path[-1] == "conv"
                else COMPUTE_AXES))
        return self._caches[key]

    # -- collectives --------------------------------------------------------

    def weights(self, params: dict, *path: str, group=None):
        """The subtree of ``params`` (this rank's blocks) at ``path``, each
        leaf's gathered dims whole; with ``group``, that layer group's
        slice of a stacked subtree (its leading entry dropped)."""
        tree = params
        for k in path:
            tree = tree[k]
        if group is not None:
            tree = tree_map(lambda t: t[group], tree)
        return self.whole(tree, *path, stacked=group is not None)

    def whole(self, blocks: dict, *path: str, stacked: bool = False):
        """``blocks`` (this rank's blocks of the subtree at ``path``; with
        ``stacked``, one group's slices of a stacked subtree) with each
        leaf's gathered dims all-gathered."""
        gather, spec = self.gather, self.spec
        for k in path:
            gather, spec = gather[k], spec[k]

        def use(leaf, dims, sp):
            if not stacked:
                return gather_at_use(leaf, sp, dims, self.mesh)
            return gather_at_use(leaf, sp[1:], _in_group(dims), self.mesh)
        return tree_map(use, blocks, gather, spec)

    def block(self, full: Tensor, gathered, spec) -> Tensor:
        """This rank's block of a tensor whole along its gathered dims."""
        return local_block(full, spec, self.mesh, gathered)

    def reduce(self, y: Tensor, on: bool) -> Tensor:
        return reduce_sum(y, self.mesh.model_group) if on else y

    # -- vocab --------------------------------------------------------------

    def table(self, params: dict, name: str) -> Tensor:
        """The (vocab block, d_model) table ``embed`` or ``unembed``."""
        return self.weights(params, name, "table")

    def logit_table(self, params: dict, embed: Tensor) -> Tensor:
        return embed if self.cfg.tie_embeddings else self.table(params,
                                                                "unembed")

    def embed(self, table: Tensor, tokens: Tensor,
              positions: Tensor) -> Tensor:
        """Vocab-parallel lookup: the rows of this rank's vocab range, zero
        for the others, summed over 'model'; sinusoidal positions added
        where the arch has no RoPE."""
        local = tokens - self.vocab_lo
        inside = (local >= 0) & (local < self.vocab_local)
        h = table[local.clamp(0, self.vocab_local - 1)]
        h = self.reduce(torch.where(inside[..., None], h, 0),
                        self.reduce_embed)
        if not self.rope:
            h = h + sinusoidal_positions(positions, self.cfg.d_model).to(
                h.dtype)
        return h


# ---------------------------------------------------------------------------
# the mixers on the grid
# ---------------------------------------------------------------------------

def _mamba2(lay: GridLayout, plan: Mamba, p: dict, x: Tensor, **state):
    """``mamba2.mamba2_block`` on the rank's ssm heads: ``in_proj``'s
    output all-gathered where its columns are on 'model', the norm's sum of
    squares and the ``out_proj`` product summed where the heads are the
    rank's.  ``conv_state`` is whole (gathered), ``ssm_state`` the rank's
    heads'."""
    def whole(proj):
        if not plan.gather_proj:
            return proj
        return gather_dim(proj, 2, lay.mesh.model_group)
    return m2.mamba2_block(p, x, lay.cfg.ssm, heads=plan.heads, whole=whole,
                           total=lambda t: lay.reduce(t, plan.local),
                           **state)


def _time_mix(lay: GridLayout, plan: Rwkv, p: dict, x: Tensor, **state):
    """``rwkv6.time_mix`` on the rank's heads, ``w_o`` row-parallel."""
    return rw.time_mix(p, x, total=lambda t: lay.reduce(t, plan.reduce_time),
                       **state)


def _channel_mix(lay: GridLayout, plan: Rwkv, p: dict, x: Tensor, **state):
    """``rwkv6.channel_mix`` with ``w_ck``/``w_cv`` an MLP on the grid: the
    gate sigmoid(x ``w_cr``), computed whole, times the summed product."""
    return rw.channel_mix(p, x, total=lambda t: lay.reduce(
        t, plan.reduce_channel), **state)


def _ffn(lay: GridLayout, plan: Ffn, w: dict, x: Tensor, moe: bool):
    """The slot's MLP or MoE on the grid: (y summed over 'model', the MoE
    auxiliary loss of the rank's rows or None)."""
    if moe:
        y, aux = moe_ffn(w, x, lay.cfg.moe, experts=plan.experts)
    else:
        y, aux = mlp(w, x), None
    return lay.reduce(y, plan.reduce), aux


# ---------------------------------------------------------------------------
# full sequence (prefill)
# ---------------------------------------------------------------------------

def _slot_full(lay: GridLayout, slot, name: str, w: dict, x: Tensor, *,
               positions: Tensor, k_pos: Tensor, cross_src: Tensor | None,
               shared: dict | None, cache_len: int, emit_cache: bool = True):
    """One pattern slot over a full sequence on the grid: (x, its cache
    leaves whole along their gathered dims (none without ``emit_cache``),
    MoE aux)."""
    from .model import _cache_len, _ring_from_prefill, _shared_window
    cfg, plan = lay.cfg, lay.slots[name]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache: dict = {}
    if slot.kind == "attn":
        h = rmsnorm(w["norm1"], x, cfg.norm_eps)
        y, (k, v) = multihead_attention(
            w["attn"], h, h, q_pos=positions, k_pos=k_pos, causal=True,
            window=slot.window, softcap=cfg.attn_logit_softcap,
            qk_norm=cfg.use_qk_norm, rope_theta=lay.rope,
            norm_eps=cfg.norm_eps, return_kv=True,
            kv_heads=plan["attn"].kv_index)
        x = x + lay.reduce(y, plan["attn"].reduce)
        if emit_cache:
            tc = _cache_len(cache_len, slot.window)
            cache["k"], cache["v"] = (_ring_from_prefill(k, tc),
                                      _ring_from_prefill(v, tc))
    elif slot.kind == "mamba2":
        h = rmsnorm(w["norm1"], x, cfg.norm_eps)
        y, (cache["conv"], cache["ssm"]) = _mamba2(lay, plan["mixer"],
                                                   w["mixer"], h)
        x = x + y
    elif slot.kind == "rwkv6":
        h = rmsnorm(w["norm1"], x, cfg.norm_eps)
        y, (cache["tm_shift"], cache["wkv"]) = _time_mix(
            lay, plan["mixer"], w["mixer"], h)
        x = x + y
        h = rmsnorm(w["norm2"], x, cfg.norm_eps)
        y, cache["cm_shift"] = _channel_mix(lay, plan["mixer"], w["mixer"],
                                            h)
        x = x + y

    if slot.shared_attn:
        h = rmsnorm(shared["norm"], x, cfg.norm_eps)
        win = _shared_window(cfg)
        y, (k, v) = multihead_attention(
            shared["attn"], h, h, q_pos=positions, k_pos=k_pos, causal=True,
            window=win, rope_theta=lay.rope, norm_eps=cfg.norm_eps,
            return_kv=True, kv_heads=lay.shared.kv_index)
        x = x + lay.reduce(y, lay.shared.reduce)
        if emit_cache:
            tc = _cache_len(cache_len, win)
            cache["shared_k"], cache["shared_v"] = (
                _ring_from_prefill(k, tc), _ring_from_prefill(v, tc))

    if slot.cross_attn:
        h = rmsnorm(w["cross_norm"], x, cfg.norm_eps)
        l = cross_src.shape[1]
        y, (cache["cross_k"], cache["cross_v"]) = multihead_attention(
            w["cross_attn"], h, cross_src, q_pos=positions,
            k_pos=torch.arange(l, dtype=torch.int32, device=x.device),
            causal=False, rope_theta=0.0, norm_eps=cfg.norm_eps,
            return_kv=True, kv_heads=plan["cross_attn"].kv_index)
        x = x + lay.reduce(y, plan["cross_attn"].reduce)

    if slot.kind == "attn":
        h = rmsnorm(w["norm2"], x, cfg.norm_eps)
        y, a = _ffn(lay, plan["ffn"], w["ffn"], h, slot.moe)
        x = x + y
        if a is not None:
            aux = aux + a
    return x, cache, aux


def _encode(lay: GridLayout, params: dict, frames: Tensor) -> Tensor:
    """``model._encode`` on the grid over the rank's rows of ``frames``:
    each layer head-parallel and row-parallel like a decoder slot; where
    autograd records, each layer rematerialized with its weights gathered
    inside."""
    cfg, plan = lay.cfg, lay.encoder
    b, l, _ = frames.shape
    pos = torch.arange(l, dtype=torch.int32, device=frames.device)
    h = frames + sinusoidal_positions(pos, cfg.d_model)[None].to(frames.dtype)

    def encoder_layer(blocks, h):
        w = lay.whole(blocks, "encoder", "groups", stacked=True)["slot0"]
        hn = rmsnorm(w["norm1"], h, cfg.norm_eps)
        h = h + lay.reduce(multihead_attention(
            w["attn"], hn, hn, q_pos=pos[None].expand(b, -1), k_pos=pos,
            causal=False, rope_theta=0.0, norm_eps=cfg.norm_eps,
            kv_heads=plan["attn"].kv_index), plan["attn"].reduce)
        return h + _ffn(lay, plan["ffn"], w["ffn"],
                        rmsnorm(w["norm2"], h, cfg.norm_eps), False)[0]

    remat = torch.is_grad_enabled()
    for g in range(cfg.encoder.n_layers):
        blocks = tree_map(lambda t: t[g], params["encoder"]["groups"])
        h = (checkpoint(encoder_layer, blocks, h, use_reentrant=False)
             if remat else encoder_layer(blocks, h))
    return rmsnorm(params["encoder"]["final_norm"], h, cfg.norm_eps)


def _cross_source(lay: GridLayout, params: dict, batch: dict, rows,
                  dtype) -> Tensor | None:
    """The rank's rows (``rows``: the batch dim's spec) of the
    cross-attention source: the encoder's states over ``frames``
    (whisper), the image ``patches`` as given (VLM), or None."""
    cfg = lay.cfg
    if cfg.encoder is not None:
        frames = local_block(batch["frames"], rows, lay.mesh)
        return _encode(lay, params, frames.to(dtype))
    if cfg.cross_attn_source_len:
        return local_block(batch["patches"], rows, lay.mesh).to(dtype)
    return None


def _backbone(lay: GridLayout, params: dict, batch: dict, *,
              emit_cache: bool, max_cache_len: int, dtype):
    """The embedding and the layer groups over this rank's rows of the
    global batch, ``params`` already in the compute dtype.  Returns
    (hidden after the final norm, the gathered embedding table, MoE aux of
    the rank's rows summed over slots and groups, the ``ShardedCache`` or
    None)."""
    cfg, mesh = lay.cfg, lay.mesh
    tokens = batch["tokens"]
    b, s = tokens.shape
    rows = lay.rows_spec(b, s)
    tokens = local_block(tokens, rows, mesh)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[
        None].expand(tokens.shape[0], -1)
    embed = lay.table(params, "embed")
    h = lay.embed(embed, tokens, positions)
    cross_src = _cross_source(lay, params, batch, rows[:1], dtype)
    shared = lay.weights(params, "shared") if cfg.has_shared_attn else None
    if torch.is_grad_enabled() and not emit_cache:
        h, aux = _groups_remat(lay, params, h, b, positions=positions,
                               cross_src=cross_src, shared=shared)
        del shared, cross_src
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        return h, embed, aux, None
    cache_len = max(max_cache_len, s)
    c_spec, c_gather = lay.cache_layout(b, cache_len)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    stacked = None
    for g in range(cfg.n_groups):
        gp = lay.weights(params, "groups", group=g)
        caches = {}
        for i, slot in enumerate(cfg.layer_pattern):
            name = f"slot{i}"
            h, c, a = _slot_full(lay, slot, name, gp[name], h,
                                 positions=positions, k_pos=positions[0],
                                 cross_src=cross_src, shared=shared,
                                 cache_len=cache_len)
            aux = aux + a
            if emit_cache:
                caches[name] = {k: lay.block(t, _in_group(c_gather[name][k]),
                                             c_spec[name][k][1:])
                                for k, t in c.items()}
        del gp
        if emit_cache:
            if stacked is None:
                stacked = tree_map(lambda c: c.new_empty(
                    (cfg.n_groups,) + tuple(c.shape)), caches)
            tree_map(lambda dst, c: dst[g].copy_(c), stacked, caches)
        del caches
    del shared, cross_src
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h, embed, aux, (ShardedCache(stacked, b, cache_len) if emit_cache
                           else None)


def _groups_remat(lay: GridLayout, params: dict, h: Tensor, batch: int, *,
                  positions: Tensor, cross_src: Tensor | None,
                  shared: dict | None):
    """The layer groups where autograd records, rematerialized as
    ``model._backbone_full`` does: each slot (``cfg.period`` > 4) or each
    group is a checkpointed function that gathers its own weights from the
    rank's blocks, so the backward's recompute gathers them again.  The
    carry into each group is the rank's sequence block by ``act_seq``
    (whole where the sequence does not divide 'model'), gathered again
    where the group starts and before the final norm.  ``batch``: the
    global rows.
    Returns (hidden (B_local, S, D), MoE aux of the rank's rows)."""
    cfg, mesh = lay.cfg, lay.mesh
    s, d = h.shape[1], h.shape[2]
    seq = spec_for(("batch", "act_seq", None), (batch, s, d), mesh)[1]
    cut = (None, seq, None)
    k_pos = positions[0]

    def whole(x):
        return x if seq is None else gather_dim(x, 1, mesh.model_group)

    def slot_fn(i, blocks, x):
        w = lay.whole(blocks, "groups", f"slot{i}", stacked=True)
        x, _, aux = _slot_full(lay, cfg.layer_pattern[i], f"slot{i}", w, x,
                               positions=positions, k_pos=k_pos,
                               cross_src=cross_src, shared=shared,
                               cache_len=s, emit_cache=False)
        return x, aux

    def group_fn(blocks, x):
        x = whole(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(len(cfg.layer_pattern)):
            x, a = slot_fn(i, blocks[f"slot{i}"], x)
            aux = aux + a
        return keep_block(x, cut, mesh), aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    h = keep_block(h, cut, mesh)
    for g in range(cfg.n_groups):
        blocks = tree_map(lambda t: t[g], params["groups"])
        if cfg.period > 4:
            h = whole(h)
            for i in range(len(cfg.layer_pattern)):
                h, a = checkpoint(slot_fn, i, blocks[f"slot{i}"], h,
                                  use_reentrant=False)
                aux = aux + a
            h = keep_block(h, cut, mesh)
        else:
            h, a = checkpoint(group_fn, blocks, h, use_reentrant=False)
            aux = aux + a
    return whole(h), aux


def forward(lay: GridLayout, params: dict, batch: dict, *,
            emit_cache: bool = False, max_cache_len: int = 0,
            dtype=torch.bfloat16):
    """Full-sequence forward on the grid.  ``batch`` is the GLOBAL batch,
    the same on every rank (the JAX step's global arrays): ``tokens`` (B,
    S) and, for whisper, ``frames``, for a VLM ``patches``; the rank runs
    its rows.  Returns (hidden (B_local, S, D), the MoE auxiliary loss of
    the rank's rows (zero without MoE slots), this rank's cache blocks as a
    ``ShardedCache`` or None)."""
    from .model import cast_params
    h, _, aux, cache = _backbone(lay, cast_params(params, dtype), batch,
                                 emit_cache=emit_cache,
                                 max_cache_len=max_cache_len, dtype=dtype)
    return h, aux, cache


def prefill(lay: GridLayout, params: dict, batch: dict, *,
            max_cache_len: int = 0, dtype=torch.bfloat16):
    """The grid's prefill of the global ``batch`` (see ``forward``).
    Returns (this rank's last-token logits (B_local, V_local) float32:
    its rows, its vocab range from ``lay.vocab_lo``; its ``ShardedCache``;
    its rows' positions (B_local,) int32)."""
    from .model import cast_params
    params = cast_params(params, dtype)
    h, embed, _, cache = _backbone(lay, params, batch, emit_cache=True,
                                   max_cache_len=max_cache_len, dtype=dtype)
    logits = h[:, -1].float() @ lay.logit_table(params, embed).float().T
    s = batch["tokens"].shape[1]
    return logits, cache, torch.full((h.shape[0],), s, dtype=torch.int32,
                                     device=h.device)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

class _LogSumExp(torch.autograd.Function):
    """log Σ exp over the last dim of logits whose vocab is cut over a
    group (the whole vocab where ``group`` is None): the max all-reduced
    by MAX, the sum of exp by a sum, as ``torch.logsumexp`` computes it on
    one rank.  The backward is the adjoint of the whole: the gradient of
    lse, summed over the group (every rank's lse is the same function of
    every rank's logits), times exp(logits - lse), ``torch.logsumexp``'s
    own backward on one rank."""

    @staticmethod
    def forward(ctx, logits, group):
        top = logits.amax(dim=-1, keepdim=True)
        if group is not None:
            all_reduce_(top, group, op=dist.ReduceOp.MAX)
        se = torch.sum(torch.exp(logits - top), dim=-1)
        if group is not None:
            all_reduce_(se, group)
        lse = se.log_().add_(top[..., 0])
        ctx.group = group
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        if ctx.group is not None:
            g = all_reduce_(g.clone(memory_format=torch.contiguous_format),
                            ctx.group)
        return g[..., None] * torch.exp(logits - lse[..., None]), None


def _xent_chunk(lay: GridLayout, h: Tensor, table: Tensor,
                labels: Tensor) -> Tensor:
    """Sum over the valid labels of one chunk of lse - gold logit, the
    logits (B_local, C, V_local) of the rank's vocab block only: the
    log-sum-exp over the model group's blocks (``_LogSumExp``) and the gold
    logit from the rank whose range holds the label, summed over
    'model'."""
    from .model import _logits_f32
    logits = _logits_f32(h, table)
    on = lay.reduce_embed
    lse = _LogSumExp.apply(logits, lay.mesh.model_group if on else None)
    local = labels - lay.vocab_lo
    inside = (local >= 0) & (local < lay.vocab_local)
    gold = torch.gather(logits, -1, local.clamp(0, lay.vocab_local - 1)[
        ..., None])[..., 0]
    gold = lay.reduce(torch.where(inside, gold, 0.0), on)
    valid = (labels >= 0).to(torch.float32)
    return torch.sum((lse - gold) * valid)


def _xent_sum(lay: GridLayout, h: Tensor, table: Tensor,
              labels: Tensor) -> Tensor:
    """The vocab-parallel ``chunked_xent`` before its mean: the sum of the
    token losses of the rank's rows ``h`` (B_local, S, D) and ``labels``
    (B_local, S), the same on every rank of a model group.  Sequence
    chunks of ``model.XENT_CHUNK``, each rematerialized where autograd
    records."""
    from .model import XENT_CHUNK as chunk
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, h.shape[1], chunk):
        args = (lay, h[:, i:i + chunk], table, labels[:, i:i + chunk])
        total = total + (checkpoint(_xent_chunk, *args, use_reentrant=False)
                         if remat else _xent_chunk(*args))
    return total


def loss_fn(lay: GridLayout, params: dict, batch: dict, *,
            dtype=torch.bfloat16):
    """``model.loss_fn`` on the grid: the GLOBAL batch in (``tokens``,
    ``labels`` with -1 masks, whisper's ``frames`` or a VLM's
    ``patches``), this rank's parameter blocks.  Returns (total, {"loss",
    "aux_loss"}), each the global value and the same on every rank: the
    mean cross-entropy over the batch's valid labels and the MoE aux loss
    averaged over 'data'.  ``total``'s backward differentiates the rank's
    share of it,

        (its rows' token losses / the batch's label count
         + AUX_LOSS_WEIGHT x its rows' aux / data blocks) / copies,

    where copies is the number of ranks that hold the same rows (the model
    group, times the data ranks where the rows are not split): the shares
    sum over the grid to the global total, so each rank's gradient is that
    of its copy of every leaf, whole once summed over the grid axes the
    leaf's spec does not name (``launch.steps``)."""
    from .model import AUX_LOSS_WEIGHT, cast_params
    mesh = lay.mesh
    h, _, aux, _ = _backbone(lay, cast_params(params, dtype), batch,
                             emit_cache=False, max_cache_len=0, dtype=dtype)
    # the logits' table is the master leaf's block, gathered as it is and
    # cast in each chunk (as model.loss_fn does): its gradient is summed
    # over the chunks (and with a tied embedding's) in float32, not in the
    # compute dtype
    table = lay.table(params, "embed" if lay.cfg.tie_embeddings
                      else "unembed")
    labels = batch["labels"]
    rows = lay.rows_spec(*labels.shape)
    xsum = _xent_sum(lay, h, table, local_block(labels, rows, mesh))
    del h
    count = torch.clamp(torch.sum(labels >= 0).to(torch.float32), min=1.0)
    parts = entry_parts(rows[0], mesh)
    copies = mesh.model * mesh.data // parts
    share = (xsum / count + AUX_LOSS_WEIGHT * aux / parts) / copies
    with torch.no_grad():
        sums = all_reduce_(torch.stack([xsum, aux]), mesh.data_group)
        loss = sums[0] / (mesh.data // parts) / count
        aux_loss = sums[1] / mesh.data
        total = loss + AUX_LOSS_WEIGHT * aux_loss
    return share + (total - share).detach(), {"loss": loss,
                                              "aux_loss": aux_loss}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _slot_decode(lay: GridLayout, slot, name: str, w: dict, x: Tensor, *,
                 pos: Tensor, cache: dict, shared: dict | None) -> Tensor:
    """One pattern slot for one token on the grid.  ``cache`` holds the
    slot's leaves whole along their gathered dims; every state is written
    into it IN PLACE, the cross-attention keys and values only read."""
    cfg, plan = lay.cfg, lay.slots[name]
    if slot.kind == "attn":
        h = rmsnorm(w["norm1"], x, cfg.norm_eps)
        y = decode_attention(w["attn"], h, cache["k"], cache["v"], pos=pos,
                             softcap=cfg.attn_logit_softcap,
                             qk_norm=cfg.use_qk_norm, rope_theta=lay.rope,
                             norm_eps=cfg.norm_eps,
                             kv_heads=plan["attn"].kv_index)
        x = x + lay.reduce(y, plan["attn"].reduce)
    elif slot.kind == "mamba2":
        h = rmsnorm(w["norm1"], x, cfg.norm_eps)
        y, (conv_st, ssm_st) = _mamba2(
            lay, plan["mixer"], w["mixer"], h, conv_state=cache["conv"],
            ssm_state=cache["ssm"], decode=True)
        x = x + y
        cache["conv"].copy_(conv_st)
        cache["ssm"].copy_(ssm_st)
    elif slot.kind == "rwkv6":
        h = rmsnorm(w["norm1"], x, cfg.norm_eps)
        y, (tm_shift, wkv_st) = _time_mix(
            lay, plan["mixer"], w["mixer"], h, shift_state=cache["tm_shift"],
            wkv_state=cache["wkv"], decode=True)
        x = x + y
        h = rmsnorm(w["norm2"], x, cfg.norm_eps)
        y, cm_shift = _channel_mix(lay, plan["mixer"], w["mixer"], h,
                                   shift_state=cache["cm_shift"])
        x = x + y
        cache["wkv"].copy_(wkv_st)
        cache["tm_shift"].copy_(tm_shift)
        cache["cm_shift"].copy_(cm_shift)

    if slot.shared_attn:
        h = rmsnorm(shared["norm"], x, cfg.norm_eps)
        y = decode_attention(shared["attn"], h, cache["shared_k"],
                             cache["shared_v"], pos=pos, rope_theta=lay.rope,
                             norm_eps=cfg.norm_eps,
                             kv_heads=lay.shared.kv_index)
        x = x + lay.reduce(y, lay.shared.reduce)

    if slot.cross_attn:
        h = rmsnorm(w["cross_norm"], x, cfg.norm_eps)
        y = cross_decode_attention(w["cross_attn"], h, cache["cross_k"],
                                   cache["cross_v"], norm_eps=cfg.norm_eps,
                                   kv_heads=plan["cross_attn"].kv_index)
        x = x + lay.reduce(y, plan["cross_attn"].reduce)

    if slot.kind == "attn":
        h = rmsnorm(w["norm2"], x, cfg.norm_eps)
        x = x + _ffn(lay, plan["ffn"], w["ffn"], h, slot.moe)[0]
    return x


def decode_step(lay: GridLayout, params: dict, cache: ShardedCache,
                tokens: Tensor, pos: Tensor, *, dtype=torch.bfloat16):
    """One serving step on the grid: this rank's rows' tokens (B_local, 1)
    and positions (B_local,), its cache blocks (updated IN PLACE: the new
    row and the recurrent states written into its blocks) -> (its logits
    (B_local, V_local) float32, the cache)."""
    from .model import _group, cast_params
    cfg = lay.cfg
    params = cast_params(params, dtype)
    embed = lay.table(params, "embed")
    h = lay.embed(embed, tokens, pos[:, None])
    c_spec, c_gather = lay.cache_layout(cache.batch, cache.seq_len)
    shared = lay.weights(params, "shared") if cfg.has_shared_attn else None
    for g in range(cfg.n_groups):
        gp = lay.weights(params, "groups", group=g)
        gc = _group(cache, g)
        for i, slot in enumerate(cfg.layer_pattern):
            name = f"slot{i}"
            c = gc[name]
            sp = {k: c_spec[name][k][1:] for k in c}
            gd = {k: _in_group(c_gather[name][k]) for k in c}
            full = {k: gather_at_use(c[k], sp[k], gd[k], lay.mesh)
                    for k in c}
            h = _slot_decode(lay, slot, name, gp[name], h, pos=pos,
                             cache=full, shared=shared)
            for k in c:
                if full[k] is not c[k] and k not in READ_ONLY:
                    c[k].copy_(lay.block(full[k], gd[k], sp[k]))
        del gp
    del shared
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    table = lay.logit_table(params, embed)
    return h[:, 0].float() @ table.float().T, cache


def argmax(lay: GridLayout, logits: Tensor) -> Tensor:
    """Greedy ids (B_local,) int32 from this rank's vocab-sharded logits:
    ``torch.argmax`` of the logits gathered over 'model' (the lowest index
    among equal maxima), from one all-gather of each rank's (max, index)."""
    val, idx = logits.max(dim=-1)
    pair = torch.stack([val.double(), (idx + lay.vocab_lo).double()], -1)
    both = all_gather_dim(pair[None], 0, lay.mesh.model_group)
    vals, ids = both[..., 0], both[..., 1]
    best = vals.max(dim=0).values
    ids = torch.where(vals == best, ids, float("inf")).min(dim=0).values
    return ids.to(torch.int32)


def gather_logits(lay: GridLayout, logits: Tensor) -> Tensor:
    """This rank's rows of the logits over the whole vocabulary."""
    if not lay.vocab_on:
        return logits
    return all_gather_dim(logits, 1, lay.mesh.model_group)

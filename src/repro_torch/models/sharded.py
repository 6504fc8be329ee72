"""The dense LM stack served on a (data, model) grid of ``torch.distributed``
ranks, laid out by the JAX package's sharding rules (``repro_torch.
sharding``): the counterpart of the JAX package's prefill and decode steps
compiled with ``param_shardings`` / ``cache_shardings`` on a mesh.

Every rank holds its block of each parameter (``convert.local_lm_params``,
or ``checkpoint.restore_resharded`` by ``launch.specs.param_shardings``) and
of each cache leaf.  The contract:

* **Batch over ``data``.**  A data rank runs its rows of the batch (all of
  them where the batch does not divide the data axis): tokens, positions
  and the batch dim of every cache leaf.
* **Compute dims stay sharded** where the rules give them ``model``:
  ``heads``, ``kv_heads``, ``mlp`` and ``vocab``.  ``wq``/``wk``/``wv`` and
  ``w_gate``/``w_up`` are column-parallel; ``wo`` and ``w_down``
  row-parallel, with one all-reduce over the model group a sublayer.  The
  embedding is vocab-parallel (a masked lookup of the rank's vocab range,
  then an all-reduce over ``model``), and the logits stay vocab-sharded:
  ``argmax`` is a cross-rank argmax that returns ``torch.argmax``'s answer
  on the gathered logits.  Where the rules leave a compute dim replicated
  over a model group of more than one rank, every rank computes it whole
  and nothing is summed.  Collectives always run: on a one-rank model
  group the all-reduces run as on a larger one.
* **Every other sharded dim is gathered at use** (``sharding.
  gather_at_use``): ``embed`` over ``data`` (the FSDP rule), ``head_dim``
  over ``model`` where ``heads`` or ``kv_heads`` does not divide, each
  group's weights as the group runs, freed after it.
* **The cache stays stored by the rules** (``cache_shardings``): a cache dim
  on ``head_dim`` or ``seq_shard`` is gathered at use, and the rank's block
  of the written cache is copied back.
* **GQA on local heads.**  A rank's query heads [r H/M, (r+1) H/M) read kv
  heads h // (H/KV).  Where ``kv_heads`` is sharded too, those are the
  rank's own kv heads; else the rank computes every kv head (its cache
  keeps them all) and attends over the ones its query heads read
  (``GridLayout.kv_index``): one kv head for all of them, or one a query
  head.  B9 runs at the local (B/data, KV_local, G_local, D).

Only the slot kinds of the dense archs run here (attention and MLP, the
embedding and unembedding); an arch with MoE, mamba2, rwkv6, shared- or
cross-attention slots or an encoder raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..sharding import (all_gather_dim, all_reduce_, gather_at_use,
                        local_block, spec_for, tree_shardings)
from .attention import decode_attention, multihead_attention
from .layers import mlp, rmsnorm
from .params import tree_map

Tensor = torch.Tensor

# logical axes a rank keeps sharded over 'model' through its computation
COMPUTE_AXES = frozenset({"heads", "kv_heads", "mlp", "vocab"})
UNSUPPORTED = ("sharded serving of MoE, mamba2, rwkv6, shared- and "
               "cross-attention slots and the encoder is ROADMAP queue A "
               "item 13; the grid runs the dense archs' attention and MLP "
               "slots")


def check_dense(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless every slot of ``cfg`` is a dense
    attention + MLP slot and there is no encoder."""
    kinds = sorted({s.kind for s in cfg.layer_pattern} - {"attn"})
    extra = [name for name, on in (
        ("moe", any(s.moe for s in cfg.layer_pattern)),
        ("shared_attn", cfg.has_shared_attn),
        ("cross_attn", any(s.cross_attn for s in cfg.layer_pattern)),
        ("encoder", cfg.encoder is not None)) if on]
    if kinds or extra:
        raise NotImplementedError(f"{cfg.name}: {kinds + extra}: "
                                  + UNSUPPORTED)


def _kept(axis, entry) -> bool:
    """A dim the rank's computation keeps as its block: a batch's rows, or
    a compute axis on 'model'."""
    return axis == "batch" or (axis in COMPUTE_AXES and entry == "model")


def _gathered(axes, spec) -> list[int]:
    """The dims of a leaf gathered at use: sharded, and not kept."""
    return [i for i, (a, e) in enumerate(zip(axes, spec))
            if e is not None and not _kept(a, e)]


def _on_model(axes, spec, name: str) -> bool:
    return any(a == name and e == "model" for a, e in zip(axes, spec))


class ShardedCache(dict):
    """This rank's blocks of a decode cache (slot -> leaf -> tensor, the
    stacked group axis first, as ``model.init_cache``'s), with the global
    ``batch`` and ``seq_len`` its layout was cut for."""

    def __init__(self, blocks: dict, batch: int, seq_len: int):
        super().__init__(blocks)
        self.batch, self.seq_len = batch, seq_len


class GridLayout:
    """The layout of one dense config on one grid: the parameters' axes and
    specs, the compute dims each rank keeps, and the kv heads its query
    heads read.  Build it once per (cfg, mesh) and pass it to ``prefill``
    and ``decode_step``."""

    def __init__(self, cfg: ModelConfig, mesh):
        from .model import abstract_params, param_axes
        check_dense(cfg)
        self.cfg, self.mesh = cfg, mesh
        self.axes = param_axes(cfg)
        self.spec = tree_shardings(self.axes, abstract_params(cfg), mesh)
        self._caches: dict = {}
        # every attention slot of a dense config has the same shapes, so
        # slot0's layout decides for all
        ax, sp = self.axes["groups"]["slot0"], self.spec["groups"]["slot0"]
        heads_on = _on_model(ax["attn"]["wq"], sp["attn"]["wq"], "heads")
        kv_on = _on_model(ax["attn"]["wk"], sp["attn"]["wk"], "kv_heads")
        mlp_on = _on_model(ax["ffn"]["w_gate"], sp["ffn"]["w_gate"], "mlp")
        self.vocab_on = _on_model(self.axes["embed"]["table"],
                                  self.spec["embed"]["table"], "vocab")
        one = mesh.model == 1
        # a row-parallel product sums partial results over 'model'
        self.reduce_attn, self.reduce_mlp = heads_on or one, mlp_on or one
        self.reduce_embed = self.vocab_on or one
        self.vocab_local = cfg.vocab_size // (mesh.model if self.vocab_on
                                              else 1)
        self.vocab_lo = mesh.model_rank * self.vocab_local \
            if self.vocab_on else 0
        self.kv_index = None
        if heads_on and not kv_on:
            hl, g = cfg.n_heads // mesh.model, cfg.n_heads // cfg.n_kv_heads
            first = mesh.model_rank * hl
            idx = torch.arange(first, first + hl) // g
            if bool((idx == idx[0]).all()):
                idx = idx[:1]
            self.kv_index = idx.to(mesh.device)

    # -- layouts ----------------------------------------------------------

    def rows_spec(self, batch: int, seq: int):
        """The spec of a (batch, seq) token array."""
        return spec_for(("batch", None), (batch, seq), self.mesh)

    def cache_layout(self, batch: int, seq_len: int):
        """(axes, specs) trees of the decode cache of ``batch`` rows and
        ``seq_len`` positions."""
        key = (batch, seq_len)
        if key not in self._caches:
            from .model import abstract_cache, cache_axes
            axes = cache_axes(self.cfg, batch, seq_len)
            self._caches[key] = (axes, tree_shardings(
                axes, abstract_cache(self.cfg, batch, seq_len), self.mesh))
        return self._caches[key]

    # -- collectives --------------------------------------------------------

    def use(self, leaf: Tensor, axes, spec) -> Tensor:
        """``leaf`` (this rank's block) with its gathered dims whole."""
        return gather_at_use(leaf, spec, _gathered(axes, spec), self.mesh)

    def use_tree(self, tree: dict, axes: dict, spec: dict, group=None):
        """``use`` over a parameter subtree; with ``group``, that layer
        group's slice of a stacked subtree (its leading entry dropped)."""
        if isinstance(tree, dict):
            return {k: self.use_tree(tree[k], axes[k], spec[k], group)
                    for k in tree}
        if group is None:
            return self.use(tree, axes, spec)
        return self.use(tree[group], axes[1:], spec[1:])

    def block(self, full: Tensor, axes, spec) -> Tensor:
        """This rank's block of a tensor whole along its gathered dims."""
        return local_block(full, spec, self.mesh, _gathered(axes, spec))

    def reduce(self, y: Tensor, on: bool) -> Tensor:
        return all_reduce_(y, self.mesh.model_group) if on else y

    # -- vocab --------------------------------------------------------------

    def table(self, params: dict, name: str) -> Tensor:
        """The (vocab block, d_model) table ``embed`` or ``unembed``."""
        return self.use(params[name]["table"], self.axes[name]["table"],
                        self.spec[name]["table"])

    def logit_table(self, params: dict, embed: Tensor) -> Tensor:
        return embed if self.cfg.tie_embeddings else self.table(params,
                                                                "unembed")

    def embed(self, table: Tensor, tokens: Tensor) -> Tensor:
        """Vocab-parallel lookup: the rows of this rank's vocab range, zero
        for the others, summed over 'model' (the dense archs use RoPE: no
        positions are added)."""
        local = tokens - self.vocab_lo
        inside = (local >= 0) & (local < self.vocab_local)
        h = table[local.clamp(0, self.vocab_local - 1)]
        return self.reduce(torch.where(inside[..., None], h, 0),
                           self.reduce_embed)


def _slot_full(lay: GridLayout, slot, w: dict, x: Tensor, *,
               positions: Tensor, k_pos: Tensor, cache_len: int):
    """One dense slot over a full sequence on the grid: (x, {k, v} rings
    of the kv heads this rank computes)."""
    from .model import _cache_len, _ring_from_prefill
    cfg = lay.cfg
    h = rmsnorm(w["norm1"], x, cfg.norm_eps)
    y, (k, v) = multihead_attention(
        w["attn"], h, h, q_pos=positions, k_pos=k_pos, causal=True,
        window=slot.window, softcap=cfg.attn_logit_softcap,
        qk_norm=cfg.use_qk_norm, rope_theta=cfg.rope_theta,
        norm_eps=cfg.norm_eps, return_kv=True, kv_heads=lay.kv_index)
    x = x + lay.reduce(y, lay.reduce_attn)
    tc = _cache_len(cache_len, slot.window)
    cache = {"k": _ring_from_prefill(k, tc), "v": _ring_from_prefill(v, tc)}
    h = rmsnorm(w["norm2"], x, cfg.norm_eps)
    return x + lay.reduce(mlp(w["ffn"], h), lay.reduce_mlp), cache


def _backbone(lay: GridLayout, params: dict, batch: dict, *,
              emit_cache: bool, max_cache_len: int):
    """The embedding and the layer groups over this rank's rows of the
    global batch, ``params`` already in the compute dtype.  Returns
    (hidden after the final norm, the gathered embedding table, the
    ``ShardedCache`` or None)."""
    cfg, mesh = lay.cfg, lay.mesh
    tokens = batch["tokens"]
    b, s = tokens.shape
    tokens = local_block(tokens, lay.rows_spec(b, s), mesh)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[
        None].expand(tokens.shape[0], -1)
    embed = lay.table(params, "embed")
    h = lay.embed(embed, tokens)
    cache_len = max(max_cache_len, s)
    c_axes, c_spec = lay.cache_layout(b, cache_len)
    stacked = None
    for g in range(cfg.n_groups):
        gp = lay.use_tree(params["groups"], lay.axes["groups"],
                          lay.spec["groups"], g)
        caches = {}
        for i, slot in enumerate(cfg.layer_pattern):
            name = f"slot{i}"
            h, c = _slot_full(lay, slot, gp[name], h, positions=positions,
                              k_pos=positions[0], cache_len=cache_len)
            if emit_cache:
                caches[name] = {k: lay.block(t, c_axes[name][k][1:],
                                             c_spec[name][k][1:])
                                for k, t in c.items()}
        del gp
        if emit_cache:
            if stacked is None:
                stacked = tree_map(lambda c: c.new_empty(
                    (cfg.n_groups,) + tuple(c.shape)), caches)
            tree_map(lambda dst, c: dst[g].copy_(c), stacked, caches)
        del caches
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h, embed, (ShardedCache(stacked, b, cache_len) if emit_cache
                      else None)


def forward(lay: GridLayout, params: dict, batch: dict, *,
            emit_cache: bool = False, max_cache_len: int = 0,
            dtype=torch.bfloat16):
    """Full-sequence forward on the grid.  ``batch["tokens"]`` is the
    GLOBAL (B, S) batch, the same on every rank (the JAX step's global
    array); the rank runs its rows.  Returns (hidden (B_local, S, D), aux
    (zero: no MoE slot), this rank's cache blocks as a ``ShardedCache`` or
    None)."""
    from .model import cast_params
    h, _, cache = _backbone(lay, cast_params(params, dtype), batch,
                            emit_cache=emit_cache,
                            max_cache_len=max_cache_len)
    return h, torch.zeros((), dtype=torch.float32, device=h.device), cache


def prefill(lay: GridLayout, params: dict, batch: dict, *,
            max_cache_len: int = 0, dtype=torch.bfloat16):
    """The grid's prefill of the global ``batch`` (see ``forward``).
    Returns (this rank's last-token logits (B_local, V_local) float32:
    its rows, its vocab range from ``lay.vocab_lo``; its ``ShardedCache``;
    its rows' positions (B_local,) int32)."""
    from .model import cast_params
    params = cast_params(params, dtype)
    h, embed, cache = _backbone(lay, params, batch, emit_cache=True,
                                max_cache_len=max_cache_len)
    logits = h[:, -1].float() @ lay.logit_table(params, embed).float().T
    s = batch["tokens"].shape[1]
    return logits, cache, torch.full((h.shape[0],), s, dtype=torch.int32,
                                     device=h.device)


def decode_step(lay: GridLayout, params: dict, cache: ShardedCache,
                tokens: Tensor, pos: Tensor, *, dtype=torch.bfloat16):
    """One serving step on the grid: this rank's rows' tokens (B_local, 1)
    and positions (B_local,), its cache blocks (updated IN PLACE: the new
    row written into its block) -> (its logits (B_local, V_local) float32,
    the cache)."""
    from .model import _group, cast_params
    cfg = lay.cfg
    params = cast_params(params, dtype)
    embed = lay.table(params, "embed")
    h = lay.embed(embed, tokens)
    c_axes, c_spec = lay.cache_layout(cache.batch, cache.seq_len)
    for g in range(cfg.n_groups):
        gp = lay.use_tree(params["groups"], lay.axes["groups"],
                          lay.spec["groups"], g)
        gc = _group(cache, g)
        for i, slot in enumerate(cfg.layer_pattern):
            name = f"slot{i}"
            w, c = gp[name], gc[name]
            ax = {k: c_axes[name][k][1:] for k in c}
            sp = {k: c_spec[name][k][1:] for k in c}
            full = {k: lay.use(c[k], ax[k], sp[k]) for k in c}
            x = rmsnorm(w["norm1"], h, cfg.norm_eps)
            y = decode_attention(w["attn"], x, full["k"], full["v"], pos=pos,
                                 softcap=cfg.attn_logit_softcap,
                                 qk_norm=cfg.use_qk_norm,
                                 rope_theta=cfg.rope_theta,
                                 norm_eps=cfg.norm_eps,
                                 kv_heads=lay.kv_index)
            for k in c:
                if full[k] is not c[k]:      # gathered: my block back
                    c[k].copy_(lay.block(full[k], ax[k], sp[k]))
            h = h + lay.reduce(y, lay.reduce_attn)
            x = rmsnorm(w["norm2"], h, cfg.norm_eps)
            h = h + lay.reduce(mlp(w["ffn"], x), lay.reduce_mlp)
        del gp
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

"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: rank 0 of
the fake 16x16 and 2x16x16 grids (torch's fake process-group backend,
meta tensors) holds ``shard_bytes``' bytes for every cell; a dry run on a
fake 1x1 grid counts what the same tracer counts on the real step over a
one-rank gloo grid; one full-size cell of each kind traces; the CLI's KRR
cells on the 2x16x16 grid; and real (pod 2, data 1, model 2) and (pod 2,
data 2, model 1) gloo grids serve the smoke prefill and take one train
step as the one-process port does.

Bytes and counts are held exactly (they are sums of shapes); the grids'
logits within 1e-5 of max|logit| of the one-process port, the tolerance of
``tests/test_torch_lm_mesh.py``, and the train step's gradient blocks,
loss and grad_norm within those of ``tests/test_torch_train_mesh.py``: a
row-parallel product and a gradient's sum over ranks add their partial
sums in another order."""
import json
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.configs.wlsh_krr import CONFIG as KRR
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (Mesh, fake_grid, init_distributed,
                                     make_host_mesh, make_production_mesh)
from repro_torch.launch.specs import (batch_specs, param_shardings,
                                      shard_bytes)
from repro_torch.launch.steps import init_train_state
from repro_torch.models import model as TM
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.roofline import Tracer
from repro_torch.sharding import (collective_counts, local_block,
                                  reset_collective_counts)
from repro_torch.testing.multirank import spawn_ranks

from torch_lm_mesh_common import np_params
from torch_train_mesh_common import (grad_ratios, lm_batch, reference,
                                     train_case, worst)

JAX_ROW_KEYS = {"name", "chips", "hlo_flops", "hbm_bytes", "collective_bytes",
                "bytes_per_device", "t_compute_s", "t_memory_s",
                "t_collective_s", "dominant", "model_flops",
                "useful_flop_frac", "roofline_frac", "arg_bytes_per_device",
                "temp_bytes_per_device", "output_bytes_per_device",
                "collective_counts", "collective_bytes_by_op",
                "xla_flops_per_dev"}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rank0_arguments_are_shard_bytes(multi_pod):
    """Every (arch x allowed shape) cell: rank 0's argument bytes are
    ``shard_bytes`` on the dict mesh (held against the JAX package's
    specs in ``tests/test_torch_sharding.py``): parameters, AdamW state
    and batch for train; parameters, batch (the cache is an output) for
    prefill; parameters, cache and the rows' tokens and positions for
    decode."""
    sizes = {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}
    with make_production_mesh(multi_pod=multi_pod) as mesh:
        assert mesh.axis_sizes == sizes and mesh.size == math.prod(
            sizes.values()) and mesh.data_rank == mesh.model_rank == 0
        for kind, arch, shape in dryrun.iter_cells("lm", None, None):
            cfg, spec = registry.get_config(arch), SHAPES[shape]
            cell = dryrun.lower_lm_cell(arch, shape, mesh)
            dt = torch.float32 if spec.kind == "train" else torch.bfloat16
            want = shard_bytes(cfg, spec, sizes, param_dtype=dt,
                               cache_dtype=torch.bfloat16)
            total = want["total"] - (want["cache"]
                                     if spec.kind == "prefill" else 0)
            assert cell.arg_bytes == total, (arch, shape)


@pytest.mark.parametrize("micro", [1, 4])
def test_fake_grid_dry_run_counts_the_real_step(tmp_path, micro):
    """gemma3-1b's smoke train step (float32 compute: the CPU's bf16 logits
    product differs from the card's, which meta tensors take) on a fake
    1x1 grid on meta tensors, and on a one-rank gloo grid on CPU tensors:
    the same FLOPs, bytes and collectives, and the collectives as
    ``sharding.collective_counts`` tallies them (its reduce-scatter is an
    all-reduce of the whole tensor).  At 4 microbatches the dry run
    traces two and scales the second (``roofline.trips``), the CPU step
    runs all four."""
    cfg = registry.smoke_config("gemma3-1b")
    shape = ShapeSpec("s", 16, 4, "train")
    with fake_grid(1, 1) as mesh:
        cell = dryrun.lower_lm_cell("gemma3-1b", shape, mesh, cfg=cfg,
                                    micro=micro, dtype=torch.float32)
        dry, _ = dryrun.trace_cell(cell)
    init_distributed("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                     world_size=1)
    try:
        mesh = make_host_mesh(device="cpu")
        cell = dryrun.lower_lm_cell("gemma3-1b", shape, mesh, cfg=cfg,
                                    micro=micro, dtype=torch.float32)
        params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                       mesh=mesh)
        batch = {k: torch.randint(0, cfg.vocab_size, t.shape,
                                  generator=torch.Generator().manual_seed(1),
                                  dtype=t.dtype)
                 for k, t in batch_specs(cfg, shape).items()}
        reset_collective_counts()
        with Tracer() as tracer:
            cell.step(params, opt, batch)
        tally = collective_counts()
    finally:
        dist.destroy_process_group()
    assert dry.summary() == tracer.trace.summary()
    assert dry.flops > 0 and not dry.stand_ins
    c, none = dry.collectives, {"calls": 0, "bytes": 0}
    for key in ("calls", "bytes"):
        assert c["all_reduce"][key] == tally["all_reduce"][key] + \
            tally.get("reduce_scatter", none)[key]
    assert c.get("all_gather", none) == tally.get("all_gather", none)


def test_full_size_cells_trace_on_the_pod():
    """gemma3-1b ``decode_32k`` and the KRR step's ``krr_4m`` (psum) on the
    16x16 grid: the JAX row's keys, finite terms, each kernel of the path
    credited (B9 once an attention layer; B1 once, and the split matvec's
    B3 and B6 once a matvec)."""
    with make_production_mesh() as mesh:
        rows = [dryrun.run_cell("lm", "gemma3-1b", "decode_32k", mesh, "p"),
                dryrun.run_cell("krr", "wlsh_krr", "krr_4m", mesh, "p")]
    for row in rows:
        assert set(row) >= JAX_ROW_KEYS | {"trace_s", "stand_ins",
                                           "kernel_credits", "host_reads"}
        assert all(math.isfinite(row[k]) and row[k] >= 0 for k in (
            "hlo_flops", "hbm_bytes", "t_compute_s", "t_memory_s",
            "t_collective_s"))
        assert row["chips"] == 256 and row["hlo_flops"] > 0
    credits = rows[0]["kernel_credits"]
    assert list(credits) == ["flash_decode"]
    assert credits["flash_decode"]["calls"] == \
        registry.get_config("gemma3-1b").n_layers
    credits = rows[1]["kernel_credits"]
    assert credits["featurize"]["calls"] == 1
    iters = KRR.cg_iters
    assert credits["bin_gather_blocked"]["calls"] == iters + 1
    assert credits["bin_scatter_blocked"]["calls"] == iters + 2
    assert rows[1]["collective_counts"]["all_reduce"] > 0


def test_cli_krr_cells_on_the_multipod_grid(tmp_path, capsys):
    """``--cells krr --mesh multipod``: both KRR shapes, one printed line
    and one JSONL row each, exit 0; the data axes span both pods (x's
    rows cut 32 ways)."""
    out = tmp_path / "rows.jsonl"
    assert dryrun.main(["--cells", "krr", "--mesh", "multipod",
                        "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["name"] for r in rows] == [
        "wlsh_krr/krr_4m/multipod2x16x16", "wlsh_krr/krr_32m/multipod2x16x16"]
    assert rows[0]["arg_bytes_per_device"] == (4_194_304 // 32) * 65 * 4 + \
        4 * (64 // 16) * 64 * 4
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("[dryrun] wlsh_krr")]
    assert len(printed) == 2


@pytest.fixture(scope="module")
def pod_inputs():
    """gemma3-1b's smoke config, prompt tokens, a train case (float32) and
    the one-process port's prefill logits and train step reference."""
    cfg = registry.smoke_config("gemma3-1b")
    params = np_params(cfg, np.random.default_rng(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 9))
    case = train_case("gemma3-1b", cfg, params, lm_batch(cfg, 100))
    with torch.inference_mode():
        want = TM.prefill(cfg, tree_map(torch.from_numpy, params),
                          {"tokens": torch.from_numpy(tokens)},
                          dtype=torch.float32)[0].numpy()
    return cfg, tokens, case, want, reference(cfg, params, case["batch"],
                                              jax_too=False)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 1)],
                         ids=["pod2x1x2", "pod2x2x1"])
def test_pod_grid_matches_one_process(tmp_path, pod_inputs, data, model):
    """A real (pod 2, data, model) gloo grid of four ranks: each axis's
    group (``sharding.group_of``) holds the ranks the row-major (pod,
    data, model) layout puts there; the batch's rows split over both pods'
    data ranks; the smoke prefill's logits within 1e-5 of max|logit| of
    the one-process port; one train step's loss within 1e-5 relative and
    grad_norm within 1e-6 relative of the one-process step's, and every
    gradient block (``param_shardings`` on the grid with pods: ``embed``
    cut over the in-pod data group) within 1e-4 of the leaf's max|g| or 4x
    its float32 floor: the tolerances of ``tests/test_torch_lm_mesh.py``
    and ``tests/test_torch_train_mesh.py``.  At (2, 2, 1) the in-pod data
    group and the pod group each have two ranks, so the FSDP gather and
    the gradient's sums over 'pod' and over ('pod', 'data') move data."""
    cfg, tokens, case, want, ref = pod_inputs
    res = spawn_ranks(4, model, str(tmp_path), {}, [
        ("p", {"mode": "prefill", "cfg": cfg, "params": case["params"],
               "tokens": tokens}),
        ("t", {"mode": "train", "cases": [case]})], pods=2)
    whole = dict(tree_leaves(ref["grads"]))
    at = lambda p, i, j: (p * data + i) * model + j
    for rank, r in enumerate(res):
        lin, mi = divmod(rank, model)
        pod, di = divmod(lin, data)
        p = r["p"]
        assert p["axis_sizes"] == {"pod": 2, "data": data, "model": model}
        assert p["groups"] == {
            "data": [at(pod, i, mi) for i in range(data)],
            "pod": [at(q, di, mi) for q in range(2)],
            "pod_data": [at(q, i, mi) for q in range(2)
                         for i in range(data)],
            "model": [at(pod, di, j) for j in range(model)]}
        rows = 4 // (2 * data)
        assert list(p["rows"]) == list(range(lin * rows, (lin + 1) * rows))
        np.testing.assert_allclose(p["logits"], want[p["rows"]],
                                   atol=1e-5 * np.abs(want).max(), rtol=0)
        got = r["t"]["cases"]["gemma3-1b"]["step"]
        for key in ("loss", "grad_norm"):
            tol = 1e-5 if key == "loss" else 1e-6
            assert abs(got["metrics"][key] - ref["step"]["metrics"][key]) \
                <= tol * abs(ref["step"]["metrics"][key]), key
        mesh = Mesh(data=2 * data, model=model, data_rank=lin,
                    model_rank=mi, data_group=None, model_group=None,
                    device=torch.device("cpu"), pods=2)
        spec = dict(tree_leaves(param_shardings(cfg, mesh)))
        want_g = {path: np.asarray(local_block(a, spec[path], mesh))
                  for path, a in whole.items()}
        blocks = dict(tree_leaves(got["grads"]))
        assert {k: v.shape for k, v in blocks.items()} == \
            {k: v.shape for k, v in want_g.items()}
        assert blocks["['embed']['table']"].shape[1] == cfg.d_model // data
        ratios = grad_ratios(blocks, want_g, whole, ref["floor"])
        assert worst(ratios)[0] <= 1.0, (rank, worst(ratios))

"""Batched serving CLI of the port: prefill a prompt batch, then decode
tokens one step at a time against the ring-buffer caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 32

On a (data, model) grid of ranks, one process a rank under ``torchrun``
(every arch; ``models.sharded``):

    PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.serve \
        --mesh 2x2 --arch whisper-large-v3 --smoke --device cpu

The flags are those of ``repro.launch.serve`` plus ``--device`` (default
``cuda``; without a card that raises, there is no fallback) and ``--mesh
DxM`` (data x model ranks: NCCL on the card, gloo on the CPU; on a grid the
weights, the prompt and the source are drawn on the host, the weights leaf
by leaf with each rank keeping its blocks, so they are not the one-process
CLI's draws).  Weights, the prompt and, for whisper and the VLM, the
encoder frames or image patches (``steps.source_inputs``) are random from
``--seed``, in float32 as the JAX CLI serves.
Greedy decoding at ``--temperature 0``, else sampling from a generator
seeded from ``--seed``.  Prints prefill ms, decode tok/s and the first
sample ids.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..backend import resolve_device
from ..configs import registry
from ..configs.base import ModelConfig
from ..models import model, sharded
from ..sharding import all_gather_dim, local_block
from .steps import make_decode_step, make_prefill_step, source_inputs


def _clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def sample(logits: torch.Tensor, temperature: float,
           generator: torch.Generator) -> torch.Tensor:
    """(B, V) f32 logits -> (B,) int32 ids: argmax at temperature 0, else a
    draw from softmax(logits / temperature)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def grid_sample(lay: sharded.GridLayout, logits: torch.Tensor,
                temperature: float, generator: torch.Generator):
    """``sample`` on a grid, from this rank's vocab-sharded logits: the
    cross-rank argmax at temperature 0, else a draw from the logits
    gathered over the model group (the model ranks' generators draw
    alike)."""
    if temperature <= 0:
        return sharded.argmax(lay, logits)
    return sample(sharded.gather_logits(lay, logits), temperature, generator)


@torch.inference_mode()
def generate(cfg: ModelConfig, params: dict, tokens: torch.Tensor, gen: int,
             *, temperature: float = 0.0, generator: torch.Generator,
             dtype=torch.float32, source: dict | None = None, mesh=None,
             logits: list | None = None):
    """Prefill ``tokens`` (B, S), then decode until ``gen`` tokens per row.
    ``source`` holds the batch's cross-attention source for the prefill
    (``frames`` or ``patches``, see ``steps.source_inputs``), where the
    arch has one.  Returns (ids (B, gen) int32, prefill seconds, decode
    seconds), each time ended by a device synchronize; the first id comes
    from the prefill logits, the other gen - 1 from decode steps.  Each
    step's logits are appended to ``logits`` where it is given.

    With ``mesh`` the run is on that grid of ranks (every rank calls it):
    ``params`` are this rank's blocks, ``tokens`` and ``source`` the global
    batch's; the rank decodes its rows (its logits its rows over its vocab
    range) and the ids come back global, gathered over the data group at
    the end."""
    dev = tokens.device
    b, s = tokens.shape
    prefill = make_prefill_step(cfg, max_cache_len=s + gen, dtype=dtype,
                                mesh=mesh)
    decode = make_decode_step(cfg, dtype=dtype, mesh=mesh)
    lay = None if mesh is None else sharded.GridLayout(cfg, mesh)

    def pick(lg):
        if logits is not None:
            logits.append(lg)
        if lay is None:
            return sample(lg, temperature, generator)[:, None]
        return grid_sample(lay, lg, temperature, generator)[:, None]

    t0 = _clock(dev)
    lg, cache, pos = prefill(params, {"tokens": tokens, **(source or {})})
    t_prefill = _clock(dev) - t0
    out = [pick(lg)]
    t0 = _clock(dev)
    for _ in range(gen - 1):
        lg, cache = decode(params, cache, out[-1], pos)
        out.append(pick(lg))
        pos = pos + 1
    t_decode = _clock(dev) - t0
    ids = torch.cat(out, dim=1)
    if lay is not None and lay.rows_spec(b, s)[0] is not None:
        ids = all_gather_dim(ids, 0, mesh.data_group)
    return ids, t_prefill, t_decode


def init_local(cfg: ModelConfig, mesh, generator: torch.Generator,
               dtype=torch.float32) -> dict:
    """This rank's blocks of parameters drawn on ``generator``'s device (the
    host, for a grid larger than one card) leaf by leaf in sorted key order
    (``params.init_params``' order), each cut by ``param_shardings`` and
    moved to ``mesh.device`` before the next is drawn."""
    from .specs import param_shardings

    def walk(spec, lay):
        if isinstance(spec, dict):
            return {k: walk(spec[k], lay[k]) for k in sorted(spec)}
        full = spec.initializer(generator, dtype)
        return local_block(full, lay, mesh).contiguous().to(mesh.device)
    return walk(model.param_specs(cfg), param_shardings(cfg, mesh))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the CUDA kernels on the card; cpu: their "
                         "plain versions")
    ap.add_argument("--mesh", default=None,
                    help="DxM: serve on a grid of D data x M model ranks "
                         "(one process a rank, under torchrun)")
    return ap.parse_args(argv)


def _grid(args):
    """(mesh, this rank's device, whether the group was joined here) of
    ``--mesh DxM`` over the process group ``torchrun`` started, or the one
    the caller runs in."""
    import torch.distributed as dist

    from .mesh import init_distributed, make_host_mesh
    d, m = (int(v) for v in args.mesh.lower().split("x"))
    joined = not dist.is_initialized()
    dev = init_distributed(args.device)
    if dist.get_world_size() != d * m:
        raise SystemExit(f"--mesh {args.mesh} needs {d * m} ranks, the "
                         f"group has {dist.get_world_size()}")
    return make_host_mesh(m, device=dev), dev, joined


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = registry.smoke_config(args.arch) if args.smoke else \
        registry.get_config(args.arch)
    mesh = None
    if args.mesh:
        mesh, dev, joined = _grid(args)
        host = torch.Generator().manual_seed(args.seed)
        params = init_local(cfg, mesh, host)
        tokens = torch.randint(0, cfg.vocab_size,
                               (args.batch, args.prompt_len),
                               generator=host).to(dev)
        # the global source, drawn on the host after the prompt; each rank
        # takes its rows in the prefill
        source = {k: v.to(dev) for k, v in source_inputs(
            cfg, args.batch, host).items()}
        gen = torch.Generator(device=dev).manual_seed(args.seed)
    else:
        dev = resolve_device(args.device)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = model.init(cfg, gen, torch.float32)
        tokens = torch.randint(0, cfg.vocab_size,
                               (args.batch, args.prompt_len), generator=gen,
                               device=dev)
        source = source_inputs(cfg, args.batch, gen)
    ids, t_prefill, t_decode = generate(
        cfg, params, tokens, args.gen, temperature=args.temperature,
        generator=gen, source=source, mesh=mesh)
    tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    if mesh is None or (mesh.data_rank, mesh.model_rank) == (0, 0):
        where = "" if mesh is None else f" ({mesh.data}x{mesh.model} grid)"
        print(f"[serve] {cfg.name} on {dev}{where}: prefill {args.batch}x"
              f"{args.prompt_len} in {t_prefill * 1e3:.1f} ms; decode "
              f"{args.gen - 1} steps -> {tps:.1f} tok/s")
        print("[serve] sample generations (token ids):")
        for row in ids[: min(2, args.batch)].tolist():
            print("   ", " ".join(str(t) for t in row[:16]), "...")
    if mesh is not None and joined:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

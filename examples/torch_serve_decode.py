"""Online serving example of the PyTorch port: fit -> export ->
micro-batched prediction.

    PYTHONPATH=src python examples/torch_serve_decode.py [--device cuda|cpu]
        [--requests N] [--mesh MxN]

Fits a small WLSH-KRR model, exports it as a serving artifact, hosts it
behind the warm-path ``Predictor`` (padding buckets, a CUDA graph each on
the card, + bucket-exact cache) and pushes a synthetic request stream
through the ``MicroBatcher`` — the same submit -> coalesce -> padded warm
path -> future path ``python -m repro_torch.launch.krr_serve`` runs at
traffic.

``--mesh MxN`` exports a sharded piece grid instead and serves it with
``ShardedPredictor`` on a (model_shards, data_shards) grid of ranks, one
process each, as ``repro_torch.launch.krr_serve --mesh`` does: rank 0 runs
this example, the other ranks serve their pieces until it stops the grid.
The process group comes from ``torchrun``'s environment (a group of one
without it): NCCL on the card, which takes one rank a device (``--mesh
1x1``), and gloo on the CPU for larger grids, e.g.

    PYTHONPATH=src torchrun --nproc_per_node 4 \\
        examples/torch_serve_decode.py --device cpu --mesh 2x2

Default is the single-process path, which runs on one device.
"""
import argparse
import contextlib
import tempfile

import numpy as np

from repro_torch.backend import resolve_device
from repro_torch.launch.krr_serve import (_fit_and_export, _synthetic_stream,
                                          serve_stream)
from repro_torch.serve import (Predictor, ShardedPredictor, bucket_sizes,
                               parse_mesh_shape)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card's kernels (raises without a card); "
                         "cpu: their plain PyTorch versions")
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--dup-frac", type=float, default=0.4,
                    help="fraction of requests replaying earlier ones "
                         "(the bucket-exact cache's traffic)")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--mesh", default=None, metavar="MxN",
                    help="serve sharded on a (model x data) grid of ranks")
    return ap.parse_args(argv)


def serve(args, mesh_shape) -> None:
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as st:
        art = tmp + "/artifact"
        print(f"[serve] fitting + exporting demo artifact -> {art}")
        model, xtr = _fit_and_export(art, n=1024, d=8, m=64,
                                     mesh_shape=mesh_shape,
                                     device=args.device)
        if mesh_shape is not None:
            predictor = st.enter_context(ShardedPredictor(
                mesh_shape=mesh_shape, device=args.device,
                cache_entries=4096))
        else:
            predictor = Predictor(device=args.device, cache_entries=4096)
        predictor.load(art)
        n_compiled = predictor.warmup(sizes=bucket_sizes(args.max_batch))
        print(f"[serve] {n_compiled} padding buckets compiled"
              + (f" (mesh {args.mesh})" if mesh_shape else ""))

        stream = _synthetic_stream(xtr.shape[1], args.requests,
                                   args.dup_frac, seed=1)
        stats = serve_stream(predictor, stream,
                             max_batch=args.max_batch, max_wait_us=1000)
        print(f"[serve] {stats['served']} requests in {stats['wall_s']:.2f}s "
              f"-> {stats['qps']:.0f} QPS "
              f"({stats['batches']} batches, mean "
              f"{stats['mean_batch']:.1f} rows)")
        print(f"[serve] latency p50 {stats['p50_us']:.0f}us "
              f"p99 {stats['p99_us']:.0f}us")
        cache = predictor.cache_stats()
        print(f"[serve] cache hit rate {cache['hit_rate']:.2f} "
              f"({cache['hits']} hits / {cache['misses']} misses)")

        # every batched answer must match the predictor's own direct path
        expect = np.asarray(predictor.predict(stream, use_cache=False))
        err = float(np.abs(stats["results"] - expect).max())
        print(f"[serve] max |batched - direct| = {err:.2e} "
              f"(max |pred| {float(np.abs(expect).max()):.2e})")
        health = predictor.health()
        print(f"[serve] health ok={health['ok']} "
              f"requests={health['requests']}")


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)
    mesh_shape = parse_mesh_shape(args.mesh) if args.mesh else None
    if mesh_shape is None:
        serve(args, None)
        return 0
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    owns = not dist.is_initialized()
    if owns:
        init_distributed(args.device)
    try:
        if dist.get_rank() == 0:
            serve(args, mesh_shape)
        else:
            # the same ShardedPredictor rank 0 builds, collectively; then
            # the worker loop until rank 0 stops the grid
            ShardedPredictor(mesh_shape=mesh_shape,
                             device=args.device).serve_forever()
        return 0
    finally:
        if owns:
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())

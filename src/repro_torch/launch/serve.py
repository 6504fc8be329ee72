"""Batched serving CLI of the port: prefill a prompt batch, then decode
tokens one step at a time against the ring-buffer caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 32

The flags are those of ``repro.launch.serve`` plus ``--device`` (default
``cuda``; without a card that raises, there is no fallback).  Weights, the
prompt and, for whisper and the VLM, the encoder frames or image patches
(``steps.source_inputs``) are random from ``--seed``, in float32 as the JAX
CLI serves.
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
from ..models import model
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


@torch.inference_mode()
def generate(cfg: ModelConfig, params: dict, tokens: torch.Tensor, gen: int,
             *, temperature: float = 0.0, generator: torch.Generator,
             dtype=torch.float32, source: dict | None = None):
    """Prefill ``tokens`` (B, S), then decode until ``gen`` tokens per row.
    ``source`` holds the batch's cross-attention source for the prefill
    (``frames`` or ``patches``, see ``steps.source_inputs``), where the
    arch has one.  Returns (ids (B, gen) int32, prefill seconds, decode
    seconds), each time ended by a device synchronize; the first id comes
    from the prefill logits, the other gen - 1 from decode steps."""
    dev = tokens.device
    prefill = make_prefill_step(cfg, max_cache_len=tokens.shape[1] + gen,
                                dtype=dtype)
    decode = make_decode_step(cfg, dtype=dtype)
    t0 = _clock(dev)
    logits, cache, pos = prefill(params, {"tokens": tokens, **(source or {})})
    t_prefill = _clock(dev) - t0
    tok = sample(logits, temperature, generator)[:, None]
    out = [tok]
    t0 = _clock(dev)
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, tok, pos)
        tok = sample(logits, temperature, generator)[:, None]
        pos = pos + 1
        out.append(tok)
    t_decode = _clock(dev) - t0
    return torch.cat(out, dim=1), t_prefill, t_decode


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
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = registry.smoke_config(args.arch) if args.smoke else \
        registry.get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(cfg, gen, torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    source = source_inputs(cfg, args.batch, gen)
    ids, t_prefill, t_decode = generate(
        cfg, params, tokens, args.gen, temperature=args.temperature,
        generator=gen, source=source)
    tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"[serve] {cfg.name} on {dev}: prefill {args.batch}x"
          f"{args.prompt_len} in {t_prefill * 1e3:.1f} ms; decode "
          f"{args.gen - 1} steps -> {tps:.1f} tok/s")
    print("[serve] sample generations (token ids):")
    for row in ids[: min(2, args.batch)].tolist():
        print("   ", " ".join(str(t) for t in row[:16]), "...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Int8 stochastic-rounding gradient compression for cross-group
reductions.  The port of ``repro.optim.compression``.

``compressed_psum`` sums a tensor over a ``torch.distributed`` group with
int8 payloads:

    each rank's partial sum -> int8 quantize (stochastic rounding, one scale
    per tensor) -> all_gather of the payloads and scales -> dequantize and
    sum on every rank.

Stochastic rounding keeps the quantizer unbiased: E[dequantize(q)] = x,
with an error below one scale step per element.  The collective always
runs, on a one-rank group too.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor


def stochastic_round_int8(x: Tensor, noise: Tensor) -> tuple[Tensor, Tensor]:
    """The quantizer given its uniform [0, 1) noise (x's shape): (q int8,
    scale f32 0-d), q = clip(floor(x / scale + noise), -128, 127) with
    scale = max|x| / 127 + 1e-30."""
    xf = x.to(torch.float32)
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-30
    q = torch.floor(xf / scale + noise)          # E[q] = x / scale
    return torch.clamp(q, -128, 127).to(torch.int8), scale


def quantize_int8(x: Tensor, generator: torch.Generator
                  ) -> tuple[Tensor, Tensor]:
    """Stochastic-rounding int8 quantization with noise drawn from
    ``generator`` (on x's device); returns (q int8, scale f32 0-d)."""
    noise = torch.rand(x.shape, generator=generator, device=x.device)
    return stochastic_round_int8(x, noise)


def dequantize_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


def _rank_generator(generator: torch.Generator, rank: int,
                    device: torch.device) -> torch.Generator:
    """A generator on ``device`` whose stream is fixed by ``generator``'s
    next draw and ``rank`` (the counterpart of ``fold_in(key, rank)``)."""
    base = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device))
    state = np.random.SeedSequence([base, rank]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) >> 1)


def compressed_psum(x: Tensor, group, generator: torch.Generator) -> Tensor:
    """The sum of ``x`` over ``group``'s ranks, each rank's term sent as
    int8 (a quarter of float32's bytes per gathered copy).  Every rank
    quantizes with its own stream (``generator`` folded with its rank),
    gathers every rank's payload and scale, and sums the dequantized
    terms in rank order, so every rank returns the same tensor."""
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    q, scale = quantize_int8(x, _rank_generator(generator, rank, x.device))
    qs = [torch.empty_like(q) for _ in range(world)]
    scales = [torch.empty_like(scale) for _ in range(world)]
    dist.all_gather(qs, q.contiguous(), group=group)
    dist.all_gather(scales, scale, group=group)
    return torch.sum(torch.stack(qs).to(torch.float32) *
                     torch.stack(scales).reshape((-1,) + (1,) * x.ndim),
                     dim=0)

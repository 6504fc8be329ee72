"""Synthetic token pipeline: deterministic, stateless, resumable.  The port
of ``repro.data.tokens``.

Batches are a pure function of (seed, step): a restart resumes at the exact
same data position, which the restartable loop (``runtime``) relies on.

The stream is a noisy affine-recurrence language: with probability 1-noise
the next token is (4097 * prev + 1231) mod V, else uniform noise.  A model
that learns the recurrence drives the loss from ln(V) toward -ln(1-noise).
The draws come from a ``torch.Generator`` seeded from (seed, step), so they
differ from the JAX package's ``jax.random`` draws: tests that compare the
two packages give both the JAX batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..backend import resolve_device

_A, _C = 4097, 1231  # affine recurrence constants


def step_generator(seed: int, step: int, *stream: int) -> torch.Generator:
    """A CPU generator whose stream is fixed by (seed, step) alone, or by
    (seed, step, *stream) for another draw of the same step."""
    state = np.random.SeedSequence([seed, step, *stream]).generate_state(
        1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) >> 1)


def synthetic_lm_batch(seed: int, step: int, *, batch: int, seq: int,
                       vocab: int, noise: float = 0.1,
                       device=None) -> dict[str, torch.Tensor]:
    """Deterministic (seed, step) -> {tokens, labels}, int64 of shape
    (batch, seq), drawn on the host and moved to ``device`` (None is the
    card; pass ``device="cpu"`` for the host).

    labels[t] = tokens[t + 1] (next-token prediction); the final label
    column is masked with -1 (ignored by ``chunked_xent``).
    """
    dev = resolve_device(device)
    gen = step_generator(seed, step)
    prev = torch.randint(0, vocab, (batch,), generator=gen)
    noise_mask = torch.rand((batch, seq), generator=gen) < noise
    noise_tok = torch.randint(0, vocab, (batch, seq), generator=gen)
    tokens = torch.empty((batch, seq), dtype=torch.int64)
    for t in range(seq):
        prev = torch.where(noise_mask[:, t], noise_tok[:, t],
                           (prev * _A + _C) % vocab)
        tokens[:, t] = prev
    labels = torch.cat([tokens[:, 1:],
                        torch.full((batch, 1), -1, dtype=torch.int64)], 1)
    return {"tokens": tokens.to(dev), "labels": labels.to(dev)}


def token_stream(seed: int, *, batch: int, seq: int, vocab: int,
                 start_step: int = 0, noise: float = 0.1, device=None):
    """Infinite generator of (step, synthetic_lm_batch) on ``device``
    (None is the card); resumable at any step."""
    step = start_step
    while True:
        yield step, synthetic_lm_batch(seed, step, batch=batch, seq=seq,
                                       vocab=vocab, noise=noise,
                                       device=device)
        step += 1

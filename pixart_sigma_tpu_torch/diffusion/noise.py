"""Per-step noise of the stochastic samplers.

A sampler asks `noise_fn(k, shape)` for the k-th unit-Gaussian draw of its
trajectory (k = 0, 1, ...). The pipeline's source is a `torch.Generator` on
the model's device, seeded from the call's `seed`; tests pass a function
that rebuilds the JAX package's per-step draws, whose keys are split
instead (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

NoiseFn = Callable[[int, Sequence[int]], torch.Tensor]


def generator_noise(generator: torch.Generator) -> NoiseFn:
    """Draws from `generator`, float32, on the generator's device, in the
    order the sampler asks for them."""
    return lambda k, shape: torch.randn(tuple(shape), generator=generator,
                                        device=generator.device, dtype=torch.float32)

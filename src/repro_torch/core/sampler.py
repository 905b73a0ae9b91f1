"""Index samplers of Algorithms 1 and 2 (port of ``repro/core/sampler.py``'s
``sample_uniform``, ``epoch_plan``, ``epoch_batches``,
``paired_epoch_batches`` and ``parallel_epoch_plan``).

All draw from an explicit ``torch.Generator``, on the generator's device.
They cannot reproduce the JAX package's threefry draws, so every consumer
(``dsekl.step_serial``, the trainer's plans, ``solver.fit``) also accepts
an explicit index plan: that is how the tests feed both packages the same
indices.

* Algorithm 1 samples I and J uniformly with replacement each step
  (``sample_uniform``, ``epoch_plan``).
* Algorithm 2 partitions a fresh permutation of [0, N) into batches
  without replacement each epoch (``epoch_batches``), and hands each
  gradient batch K expansion batches, cycling through the epoch's
  J-partition (``parallel_epoch_plan``).
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def sample_uniform(gen: torch.Generator, n: int, size: int,
                   device=None) -> Tensor:
    """Alg. 1: ``size`` iid uniform int64 indices in [0, n), with
    replacement, drawn on ``device`` (default: the generator's)."""
    return torch.randint(0, n, (size,), generator=gen,
                         device=device if device is not None else gen.device)


def epoch_plan(gen: torch.Generator, n: int, n_grad: int, n_expand: int,
               steps: int) -> Tuple[Tensor, Tensor]:
    """A whole Alg.-1 epoch's index plan, drawn in two bulk calls on the
    generator's device: ``(idx_i (steps, n_grad), idx_j (steps,
    n_expand))``, iid uniform in [0, n) with replacement."""
    idx_i = torch.randint(0, n, (steps, n_grad), generator=gen,
                          device=gen.device)
    idx_j = torch.randint(0, n, (steps, n_expand), generator=gen,
                          device=gen.device)
    return idx_i, idx_j


def epoch_batches(gen: torch.Generator, n: int, batch: int) -> Tensor:
    """Alg. 2: shuffle [0, n) and split it into ``n // batch`` batches,
    ``(n // batch, batch)`` int64; the tail ``n % batch`` indices sit this
    epoch out (a fresh permutation gives them their chance next epoch)."""
    n_batches = n // batch
    perm = torch.randperm(n, generator=gen, device=gen.device)
    return perm[: n_batches * batch].reshape(n_batches, batch)


def paired_epoch_batches(gen: torch.Generator, n: int, i_batch: int,
                         j_batch: int) -> Tuple[Tensor, Tensor]:
    """Independent without-replacement batchings for I and J (Alg. 2
    lines 2-3), drawn one after the other from ``gen``."""
    return epoch_batches(gen, n, i_batch), epoch_batches(gen, n, j_batch)


def parallel_epoch_plan(gen: torch.Generator, n: int, i_batch: int,
                        j_batch: int, n_workers: int
                        ) -> Tuple[Tensor, Tensor]:
    """The full Alg.-2 epoch plan: ``(i_batches (Bi, i_batch), idx_jk (Bi,
    K, j_batch))`` with ``K = min(n_workers, Bj)``: gradient batch b takes
    the expansion batches ``(b * K + w) % Bj`` for w < K, cycling through
    the epoch's J-partition.  The K batches of one step are disjoint (one
    permutation), so a step's J union has no duplicate index.  With
    N < i_batch the plan has no step."""
    i_batches, j_batches = paired_epoch_batches(gen, n, i_batch, j_batch)
    n_i, n_j = i_batches.shape[0], j_batches.shape[0]
    k = min(n_workers, n_j)
    if k == 0:                          # N < j_batch: no expansion batch
        return i_batches, j_batches.new_empty((n_i, 0, j_batch))
    dev = i_batches.device
    assign = (torch.arange(n_i, device=dev)[:, None] * k
              + torch.arange(k, device=dev)[None, :]) % n_j
    return i_batches, j_batches[assign]                 # (Bi, K, j_batch)

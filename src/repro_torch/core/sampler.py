"""Index samplers of Algorithms 1 and 2 and of the mesh (port of
``repro/core/sampler.py``).

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
* The mesh samples each shard's indices from its own LOCAL row range:
  with replacement each step (``mesh_step_plan``, ``mesh_epoch_plan``:
  the whole mesh's plan, so every rank that draws it from the same
  generator state holds the same plan and takes its own rows), or
  without replacement (``sharded_batches``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

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


def sharded_batches(gen: torch.Generator, n_local: int, batch: int
                    ) -> Tensor:
    """Without-replacement batches over one shard's LOCAL range [0,
    n_local): a permutation cut into ``max(n_local // batch, 1)`` batches,
    ``(n_batches, batch)``.  A shard smaller than one batch wraps its
    permutation so the batch keeps its shape (indices then repeat).  The
    JAX function folds the shard id into its key; here each shard's
    generator state is the caller's."""
    n_batches = max(n_local // batch, 1)
    perm = torch.randperm(n_local, generator=gen, device=gen.device)
    if batch > n_local:
        perm = perm.repeat(-(-batch // n_local))
    return perm[: n_batches * batch].reshape(n_batches, batch)


def mesh_step_plan(gen: torch.Generator, n_grad: int, n_expand: int,
                   rows_data: Sequence[int], rows_model: Sequence[int]
                   ) -> Tuple[Tensor, Tensor]:
    """One mesh step's plan, LOCAL indices: ``(idx_i (n_data, n_grad),
    idx_j (n_model, n_expand))``, row d uniform in [0, rows_data[d]) and
    row m in [0, rows_model[m]), with replacement."""
    i, j = mesh_epoch_plan(gen, n_grad, n_expand, rows_data, rows_model, 1)
    return i[0], j[0]


def mesh_epoch_plan(gen: torch.Generator, n_grad: int, n_expand: int,
                    rows_data: Sequence[int], rows_model: Sequence[int],
                    steps: int) -> Tuple[Tensor, Tensor]:
    """A whole mesh epoch's plan, LOCAL indices, drawn in one call a shard
    on the generator's device: ``(idx_i (steps, n_data, n_grad), idx_j
    (steps, n_model, n_expand))``.  I is drawn per data shard and J per
    model shard, so the ranks of one model column scatter the same J."""
    dev = gen.device
    idx_i = torch.stack([torch.randint(0, int(r), (steps, n_grad),
                                       generator=gen, device=dev)
                         for r in rows_data], dim=1)
    idx_j = torch.stack([torch.randint(0, int(r), (steps, n_expand),
                                       generator=gen, device=dev)
                         for r in rows_model], dim=1)
    return idx_i, idx_j

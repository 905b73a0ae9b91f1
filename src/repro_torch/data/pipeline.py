"""Deterministic, resumable synthetic LM token pipeline (port of
``repro/data/pipeline.py``).

Tokens are drawn from a fixed random bigram model (seeded), so a trained
LM can reduce its loss below log(V).  Every batch comes from numpy's
``default_rng((seed, step))``, as in JAX, so the port's tokens equal
JAX's bit for bit; the iterator state is one integer step, stored in
checkpoints for exact resume.  ``Prefetcher`` generates batches on a host
thread and places each on the device (pinned memory, ``non_blocking``).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike


class BigramPipeline:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, branching: int = 8):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = 0
        rng = np.random.default_rng(seed)
        # Each token has `branching` plausible successors (low entropy).
        self._succ = rng.integers(0, vocab_size,
                                  (vocab_size, branching)).astype(np.int32)

    # --- checkpointable state ------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        if state["seed"] != self.seed:
            raise ValueError(f"pipeline seed mismatch: checkpoint "
                             f"{state['seed']}, pipeline {self.seed}")
        self.step = int(state["step"])

    # --- generation ------------------------------------------------------
    def _gen(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s, v = self.batch, self.seq_len, self.vocab_size
        br = self._succ.shape[1]
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        choices = rng.integers(0, br, (b, s))
        for t in range(s):
            toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def next_batch(self) -> Dict[str, np.ndarray]:
        out = self._gen(self.step)
        self.step += 1
        return out

    def peek_batch(self, step: int) -> Dict[str, np.ndarray]:
        return self._gen(step)


def to_device(batch: Dict[str, np.ndarray], device: torch.device,
              pin: bool = False) -> Dict[str, torch.Tensor]:
    """A batch's arrays as int64 tensors on ``device`` (the model indexes
    with them); ``pin`` stages them in pinned memory and copies
    ``non_blocking``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).long()
        if pin and device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    return out


class Prefetcher:
    """Host-side background prefetch of pipeline batches: a thread draws
    the next ``depth`` batches and, given a ``device``, places each there
    (pinned memory, ``non_blocking``), overlapping generation with device
    compute.  ``next()`` returns batches in the pipeline's order;
    ``close()`` stops and joins the thread."""

    def __init__(self, pipeline: BigramPipeline, depth: int = 2,
                 device: DeviceLike = None):
        self.pipeline = pipeline
        self.device = None if device is None else torch.device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _worker(self):
        try:
            while not self._stop.is_set():
                batch = self.pipeline.next_batch()
                if self.device is not None:
                    batch = to_device(batch, self.device, pin=True)
                self._put(batch)
        except BaseException as e:        # re-raised by next()
            self._error = e
            self._put(None)

    def next(self):
        batch = self._q.get()
        if batch is None and self._error is not None:
            raise RuntimeError("prefetch thread failed") from self._error
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

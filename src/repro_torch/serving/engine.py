"""Batched LM serving: prefill + greedy / temperature decode with a KV
cache (port of ``repro/serving/engine.py``).

PyTorch runs eagerly, so there is no jit: ``prefill`` and ``decode_step``
call the model, and ``generate`` runs the decode step in a host loop.
Batched requests share one position counter, as in JAX.  Greedy decoding
is the parity path; temperature sampling draws from a ``torch.Generator``,
so its tokens differ from JAX's threefry draws.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from repro_torch.models.model import LanguageModel

Tensor = torch.Tensor


class ServingEngine:
    def __init__(self, model: LanguageModel, cache_len: int):
        self.model = model
        self.cache_len = cache_len

    def prefill(self, tokens: Tensor, frontend: Optional[Tensor] = None
                ) -> Tuple[Tensor, List[Any]]:
        return self.model.prefill(tokens, self.cache_len, frontend)

    def decode_step(self, token: Tensor, cache: List[Any], pos: int
                    ) -> Tuple[Tensor, List[Any]]:
        return self.model.decode_step(token, cache, int(pos))

    def generate(self, tokens: Tensor, n_new: int, *,
                 frontend: Optional[Tensor] = None,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> Tensor:
        """Greedy (temperature=0) or sampled generation, the prompts
        attending over ``frontend`` where the model has cross-attention.
        Returns (B, n_new) int64."""
        s = tokens.shape[1]
        logits, cache = self.prefill(tokens, frontend)
        out = [self._pick(logits, temperature, generator)]
        for i in range(n_new - 1):
            logits, cache = self.decode_step(out[-1], cache, s + i)
            out.append(self._pick(logits, temperature, generator))
        return torch.stack(out, dim=1)

    @staticmethod
    def _pick(logits: Tensor, temperature: float,
              generator: Optional[torch.Generator]) -> Tensor:
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

"""DSEKL as a kernel readout head over frozen LM features (port of
``repro/core/readout.py``).

The bridge DESIGN.md §4 describes: a language model's last-token hidden
state becomes the input space of a doubly stochastic kernel machine,
trained with the paper's Algorithm 1 or 2 while the backbone stays
frozen.  The frozen forward is the port's prefill
(``LanguageModel.last_hidden``, under ``torch.no_grad()``), through the
flash-attention and SSD ops (``impl``: on a card, the hand-written
kernels); the head trains through ``core/solver.fit`` and answers through
``core/dsekl.decision_function`` (the matvec kernel on a card).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.dsekl import DSEKLConfig, decision_function, truncate
from repro_torch.core.solver import FitResult, fit
from repro_torch.models.model import LanguageModel

Tensor = torch.Tensor


@torch.no_grad()
def extract_features(model: LanguageModel, tokens: Tensor,
                     frontend: Optional[Tensor] = None,
                     batch_size: int = 32, impl: str = "auto") -> Tensor:
    """Last-token hidden states (N, D) in float32, computed in batches of
    ``batch_size`` on the model's device, then standardized per feature
    (population std, as ``jnp.std``)."""
    feats = []
    for i in range(0, tokens.shape[0], batch_size):
        t = tokens[i:i + batch_size].to(model.device)
        fe = frontend[i:i + batch_size] if frontend is not None else None
        feats.append(model.last_hidden(t, fe, impl=impl))
    x = torch.cat(feats, dim=0).to(torch.float32)
    # Standardize: RBF scales are meaningful on normalized features.
    mu = torch.mean(x, dim=0, keepdim=True)
    sd = torch.std(x, dim=0, keepdim=True, correction=0) + 1e-6
    return (x - mu) / sd


class KernelReadout:
    """Frozen-backbone sequence classifier trained with DSEKL."""

    def __init__(self, cfg: DSEKLConfig):
        self.cfg = cfg
        self.alpha: Optional[Tensor] = None
        self.x_train: Optional[Tensor] = None

    def fit(self, features: Tensor, labels: Tensor,
            generator: Optional[torch.Generator] = None, n_epochs: int = 30,
            algorithm: str = "parallel",
            plans: Optional[Sequence] = None) -> FitResult:
        """Train on ``features`` (on their device) from ``generator``'s
        plans, or on explicit per-epoch ``plans`` (``solver.fit``), then
        truncate to the support vectors for prediction (paper §5)."""
        res = fit(self.cfg, features, labels, generator, plans=plans,
                  algorithm=algorithm, n_epochs=n_epochs,
                  device=features.device)
        self.alpha, self.x_train = truncate(res.state.alpha, features)
        return res

    def decision(self, features: Tensor) -> Tensor:
        if self.alpha is None:
            raise RuntimeError("call fit() first")
        return decision_function(self.cfg, self.alpha, self.x_train,
                                 features)

    def predict(self, features: Tensor) -> Tensor:
        return torch.sign(self.decision(features))

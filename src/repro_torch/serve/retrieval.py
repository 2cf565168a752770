"""RAG integration: the filtered-ANN engine in the serving loop.

Port of ``repro/serve/retrieval.py``.  ``RetrievalAugmentedServer`` embeds
a prompt with the LM (mean of the final hidden states over the positions,
in fp32, through a projection into the corpus' space, L2-normalised and
scaled by the corpus' mean norm) and issues one planned filtered-ANN query
per prompt.  One request thus runs both hand-written kernels: the LM's
through its forward pass and the ANN engine's masked L2 top-k on exact
plans.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..core.engine import FilteredANNEngine, PlannedResult
from ..core.predicates import AnyPredicate

__all__ = ["RetrievalAugmentedServer"]


class RetrievalAugmentedServer:
    def __init__(self, model, ann: FilteredANNEngine, proj: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        """``proj`` (d_model, d_corpus) is the projection into the corpus'
        space (in a real deployment the trained embedding head); without
        one it is drawn N(0, 1/d_model) from ``generator``.  The reference
        draws it from ``jax.random.PRNGKey(0)``: pass its array to get its
        embeddings (``carry.retrieval_server``)."""
        if _where(model.device) != _where(ann.device):
            raise ValueError(f"the model is on {model.device} and the ANN engine on "
                             f"{ann.device}: put both on one device")
        self.model = model
        self.ann = ann
        d_model, d_corpus = model.cfg.d_model, ann.vectors.shape[1]
        if proj is None:
            if generator is None:
                raise ValueError("pass the projection or a torch.Generator to draw it")
            proj = torch.randn((d_model, d_corpus), generator=generator, dtype=torch.float32,
                               device=generator.device) * d_model ** -0.5
        self.proj = torch.as_tensor(proj, dtype=torch.float32, device=model.device)
        if self.proj.shape != (d_model, d_corpus):
            raise ValueError(f"proj must be ({d_model}, {d_corpus}), got {tuple(self.proj.shape)}")
        # The reference recomputes this over the whole corpus on every call;
        # the corpus does not change in this slice, so once is the same value.
        self.scale = float(np.linalg.norm(ann.vectors, axis=1).mean())
        self.last_timing = {"embed_s": 0.0, "ann_s": 0.0}

    @torch.no_grad()
    def embed(self, tokens) -> np.ndarray:
        """(B, S) tokens -> (B, d_corpus) unit-norm query embeddings on the host."""
        x, _ = self.model._hidden({"tokens": tokens})
        e = x.mean(dim=1).float() @ self.proj
        e = e / torch.clamp_min(torch.linalg.vector_norm(e, dim=-1, keepdim=True), 1e-6)
        return e.cpu().numpy()

    def retrieve(self, tokens, pred: AnyPredicate, k: int = 5) -> List[PlannedResult]:
        """tokens: (B, S) -> one PlannedResult per row, under ``pred``.
        ``last_timing`` keeps the wall seconds of the embedding (ending
        with the copy to the host) and of the ANN queries."""
        t0 = time.perf_counter()
        q = self.embed(tokens) * self.scale   # into corpus space (not normalised)
        t1 = time.perf_counter()
        out = [self.ann.query(q[i], pred, k) for i in range(q.shape[0])]
        self.last_timing = {"embed_s": t1 - t0, "ann_s": time.perf_counter() - t1}
        return out


def _where(device) -> tuple:
    dev = torch.device(device)
    return dev.type, dev.index or 0

"""Batched LM serving: a fixed batch of slots, greedy decoding.

Port of ``repro/serve/engine.py``'s ``Request`` and ``ServeEngine``.  Up to
``batch_slots`` queued requests are prefilled together (prompts
left-aligned in one padded matrix; the model gathers each row's logits at
its own last position), then decoded one token per step for the whole
batch.  Greedy ``argmax`` keeps the output deterministic; each step copies
the chosen tokens to the host, as the reference does, to apply EOS and the
per-request budgets, and the batch stops stepping once every slot is done.

``ShardedANNEngine`` is not ported yet (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                   # (S,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None
    done: bool = False


class ServeEngine:
    """Serves requests through ``model.prefill`` and ``model.decode_step``
    on the model's device; the weights live in the model."""

    def __init__(self, model, batch_slots: int = 8, max_len: int = 512,
                 eos_id: Optional[int] = None):
        self.model = model
        self.device = model.device
        self.slots = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self._decode = model.decode_step
        self._prefill = lambda batch, lens: model.prefill(batch, max_len, lengths=lens)

    # ------------------------------------------------------------------
    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve all requests to completion; returns uid -> generated ids."""
        queue = list(requests)
        results: Dict[int, List[int]] = {}
        while queue:
            batch = queue[: self.slots]
            queue = queue[self.slots :]
            self._serve_batch(batch)
            for r in batch:
                results[r.uid] = r.out_tokens
        return results

    def _serve_batch(self, batch: List[Request]):
        b = len(batch)
        plens = np.array([len(r.prompt) for r in batch], np.int32)
        if not getattr(self.model, "supports_ragged_prefill", True) and len(set(plens.tolist())) > 1:
            raise ValueError(
                "this model carries recurrent prefill state, which pad "
                "tokens pollute: serve equal-length prompt batches "
                f"(got lengths {sorted(set(plens.tolist()))})")
        max_new = max(r.max_new_tokens for r in batch)
        # the last decode step writes at plen + max_new - 2; the reference
        # would drop writes past the cache silently, the port refuses
        if int(plens.max()) + max_new - 1 > self.max_len:
            raise ValueError(f"prompt of {int(plens.max())} tokens + {max_new} new tokens "
                             f"does not fit max_len={self.max_len}")
        s = int(plens.max())
        toks = np.zeros((b, s), np.int32)
        for i, r in enumerate(batch):
            toks[i, : plens[i]] = r.prompt
        lengths = torch.as_tensor(plens, device=self.device)
        logits, cache = self._prefill({"tokens": torch.as_tensor(toks, device=self.device)},
                                      lengths)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        host = next_tok.cpu().numpy()
        for i, r in enumerate(batch):
            t = int(host[i])
            r.out_tokens = [t]
            if (self.eos_id is not None and t == self.eos_id) or r.max_new_tokens <= 1:
                r.done = True
        for _ in range(max_new - 1):
            if all(r.done for r in batch):
                break  # every slot hit EOS/its budget: stop paying decode steps
            logits, cache = self._decode(cache, next_tok, lengths)
            lengths = lengths + 1
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            host = next_tok.cpu().numpy()
            for i, r in enumerate(batch):
                if len(r.out_tokens) < r.max_new_tokens and not r.done:
                    t = int(host[i])
                    r.out_tokens.append(t)
                    if self.eos_id is not None and t == self.eos_id:
                        r.done = True
                if len(r.out_tokens) >= r.max_new_tokens:
                    r.done = True
        for r in batch:
            r.done = True

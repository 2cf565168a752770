"""Batched LM serving: a fixed batch of slots, greedy decoding.

Port of ``repro/serve/engine.py``'s ``Request`` and ``ServeEngine``.  Up to
``batch_slots`` queued requests are prefilled together (prompts
left-aligned in one padded matrix; the model gathers each row's logits at
its own last position), then decoded one token per step for the whole
batch.  Greedy ``argmax`` keeps the output deterministic; each step copies
the chosen tokens to the host, as the reference does, to apply EOS and the
per-request budgets, and the batch stops stepping once every slot is done.

``ShardedANNEngine`` is the sharded filtered-ANN path: the corpus is split
into contiguous shards (``FilteredANNEngine.shard_corpus``), each query is
planned once centrally, every shard runs the same plan over its rows, and
the per-shard top-k lists merge exactly.  Writes go to the central engine
(the source of truth for every row) and to the owning shard.  ``runtime``
puts an :class:`~repro_torch.runtime.OnlineRuntime` in front of it, and
``set_tracer``/``stats`` are the reference's observability hooks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.engine import FilteredANNEngine, PlannedResult, package_results
from ..core.plan import collapse_clause_results, expand_for_execution
from ..core.predicates import AnyPredicate
from ..dist.collectives import merge_topk_unique
from ..obs.trace import NULL_TRACER

__all__ = ["Request", "ServeEngine", "ShardedANNEngine"]


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


class ShardedANNEngine:
    """Sharded filtered-ANN serving: plan once, fan out, merge top-k.

    Wraps a :class:`FilteredANNEngine` (``build_stats()`` at least;
    ``fit()`` for a trained planner).  The corpus is split into
    ``n_shards`` contiguous shards; without ``n_shards`` an engine on a CUDA
    device takes ``torch.cuda.device_count()`` shards and a CPU engine 1.
    Each query is planned centrally, run with that plan on every shard, and
    the shards' lists merge by (distance, global id): handles are unique
    across shards, so equal distances go to the lower handle, the order the
    central engine's base-first merge gives (a segment row is placed on
    shard ``handle % n_shards``, so shard order alone would not be).
    """

    def __init__(self, engine: FilteredANNEngine, n_shards: Optional[int] = None,
                 n_lists: Optional[int] = None):
        self.engine = engine
        if n_shards is None:
            n_shards = torch.cuda.device_count() if engine.device.type == "cuda" else 1
        self.n_shards = max(1, n_shards)
        self._n_lists = n_lists
        self.shards = engine.shard_corpus(self.n_shards, n_lists=n_lists)
        self.tracer = NULL_TRACER
        self._build_locators()

    def set_tracer(self, tracer) -> None:
        """Install a :class:`repro_torch.obs.Tracer` on the fan-out AND the
        central engine (planning and write spans come from the latter)."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.engine.set_tracer(tracer)

    # ------------------------------------------------------------------
    def _build_locators(self) -> None:
        """Global handle -> (owning shard, shard-local handle).  Positions in
        ``shard.ids`` ARE the local handles (``upsert_local`` appends to
        both in lockstep; deletes never remove entries)."""
        n_total = self.engine.live.n_total
        self._loc_shard = np.full(n_total, -1, np.int32)
        self._loc_pos = np.full(n_total, -1, np.int64)
        for si, s in enumerate(self.shards):
            self._loc_shard[s.ids] = si
            self._loc_pos[s.ids] = np.arange(len(s.ids), dtype=np.int64)

    def _grow_locators(self, n_total: int) -> None:
        pad = n_total - len(self._loc_shard)
        if pad > 0:
            self._loc_shard = np.concatenate([self._loc_shard, np.full(pad, -1, np.int32)])
            self._loc_pos = np.concatenate([self._loc_pos, np.full(pad, -1, np.int64)])

    def _delete_on_shards(self, gids: np.ndarray) -> None:
        gids = np.asarray(gids, np.int64).ravel()
        gids = gids[(gids >= 0) & (gids < len(self._loc_shard))]
        for si, s in enumerate(self.shards):
            sel = gids[self._loc_shard[gids] == si]
            if sel.size:
                s.delete_local(self._loc_pos[sel])

    def _place(self, gids: np.ndarray, v: np.ndarray, c: np.ndarray, m: np.ndarray) -> None:
        """Append rows with global handles ``gids`` to their owning shards
        (``handle % n_shards``)."""
        self._grow_locators(self.engine.live.n_total)
        owner = (gids % len(self.shards)).astype(np.int32)
        for si, s in enumerate(self.shards):
            rows = np.nonzero(owner == si)[0]
            if rows.size:
                lh = s.upsert_local(v[rows], c[rows], m[rows], global_ids=gids[rows])
                self._loc_shard[gids[rows]] = si
                self._loc_pos[gids[rows]] = lh

    # ------------------------------------------------------------------
    def upsert(self, vectors: np.ndarray, cat: np.ndarray, num: np.ndarray,
               ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Insert (or, with ``ids``, replace) rows: the central engine
        assigns the global handles, then each row goes to its shard.
        Returns the global handles."""
        v = np.atleast_2d(np.asarray(vectors, np.float32))
        c = np.atleast_2d(np.asarray(cat))
        m = np.atleast_2d(np.asarray(num))
        gids = self.engine.upsert(v, c, m, ids=ids)
        if ids is not None:
            # the central engine tombstoned the replaced handles already
            self._delete_on_shards(np.asarray(ids))
        self._place(gids, v, c, m)
        return gids

    def delete(self, ids: np.ndarray) -> np.ndarray:
        """Tombstone global handles centrally and on their owning shards;
        returns the newly deleted handles."""
        fresh = self.engine.delete(ids)
        self._delete_on_shards(fresh)
        return fresh

    def needs_compaction(self) -> bool:
        return self.engine.needs_compaction()

    def compact(self) -> np.ndarray:
        """Fold segment + tombstones into a rebuilt central engine, then
        re-shard it.  The old shards are dropped first (they hold views of
        the old device corpus and their own IVFs).  Returns ``id_map``."""
        self.shards = []
        id_map = self.engine.compact()
        self.shards = self.engine.shard_corpus(self.n_shards, n_lists=self._n_lists)
        self._build_locators()
        return id_map

    def maybe_compact(self) -> Optional[np.ndarray]:
        if self.engine.live.dirty and self.needs_compaction():
            return self.compact()
        return None

    def reshard(self, n_shards: int) -> "ShardedANNEngine":
        """Repartition a live deployment onto ``n_shards`` shards in place
        (dead-shard recovery: ``dist.fault`` and ``dist.elastic.replan_mesh``
        decide the count, this applies it).  The base corpus re-partitions
        through ``shard_corpus``, segment rows are placed again by the same
        owner rule, and tombstones re-apply.  Deterministic: shard builds
        are seeded by shard index."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        live = self.engine.live
        self.n_shards = n_shards
        self.shards = []
        self.shards = self.engine.shard_corpus(n_shards, n_lists=self._n_lists)
        self._build_locators()          # base rows; segment rows next
        if live.seg_n:
            gids = np.arange(live.base_n, live.n_total, dtype=np.int64)
            self._place(gids, live.seg_vectors(), np.atleast_2d(live.seg_cat()),
                        np.atleast_2d(live.seg_num()))
        if live.n_deleted:
            self._delete_on_shards(np.nonzero(~live.alive_mask())[0])
        return self

    # ------------------------------------------------------------------
    def query(self, q: np.ndarray, pred: AnyPredicate, k: int = 10) -> PlannedResult:
        plan, plan_overhead = self.engine.make_plan(pred, k)
        return self._fanout(np.atleast_2d(np.asarray(q, np.float32)), [pred], k, [plan],
                            plan_overhead)[0]

    def explain(self, pred: AnyPredicate, k: int = 10) -> str:
        """The central planner's plan for ``(pred, k)`` (plans do not depend
        on the shards)."""
        return self.engine.explain(pred, k)

    def batch_query(self, queries: np.ndarray, preds: Sequence[AnyPredicate],
                    k: int = 10) -> List[PlannedResult]:
        """Plan the batch once, run it on every shard, merge all shards' (B, k)
        lists in one call.  Ids equal B :meth:`query` calls; ``elapsed`` is
        the fan-out + merge wall time split evenly across rows."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        plans, plan_overhead = self.engine.make_plan_batch(preds, k)
        return self._fanout(queries, preds, k, plans, plan_overhead)

    def _fanout(self, queries: np.ndarray, preds: Sequence[AnyPredicate], k: int,
                plans, plan_overhead: float) -> List[PlannedResult]:
        b = len(preds)
        plan_share = plan_overhead / max(b, 1)
        exp_rows, exp_preds, decisions, ests, routes, row_map = (
            expand_for_execution(preds, plans))
        identity = len(exp_preds) == b and all(len(m) == 1 for m in row_map)
        xq = queries if identity else queries[exp_rows]
        tr = self.tracer
        t0 = time.perf_counter()
        per_shard = []
        with tr.span("shard_fanout", n_shards=len(self.shards), n_queries=len(exp_preds)):
            for si, s in enumerate(self.shards):
                with tr.span("shard", shard=si):
                    per_shard.append(s.search_batch(xq, exp_preds, k, decisions, ests,
                                                    routes=routes, tracer=tr))
        with tr.span("merge", n_shards=len(self.shards), k=int(k)):
            d, i = merge_topk_unique(np.stack([r[0] for r in per_shard]),
                                     np.stack([r[1] for r in per_shard]), k)
            rounds = np.max(np.stack([r[2] for r in per_shard]), axis=0)
            if not identity:
                d, i, rounds = collapse_clause_results(d, i, rounds, row_map, k)
        share = (time.perf_counter() - t0) / max(b, 1) + plan_share
        return package_results(d, i, rounds, plans, share, plan_share)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """The central engine's counters plus the shards' predicate caches
        summed (each shard compiles its own bitmaps) as ``shard_pred_cache``."""
        out = self.engine.stats()
        agg = {"hits": 0, "misses": 0, "evictions": 0, "size": 0, "invalidations": 0}
        n_caches = 0
        for s in self.shards:
            cache = s.ipre_exec.cache if s.ipre_exec is not None else None
            if cache is None:
                continue
            n_caches += 1
            cs = cache.stats()
            for key in agg:
                agg[key] += cs[key]
        if n_caches:
            agg["n_shards"] = n_caches
            out["shard_pred_cache"] = agg
        return out

    def runtime(self, config=None, service=None, feedback=None, tracer=None, probe=None):
        """A deadline-aware :class:`repro_torch.runtime.OnlineRuntime`
        micro-batching onto this engine's ``batch_query`` fan-out."""
        from ..runtime import OnlineRuntime

        return OnlineRuntime(self, config=config, service=service, feedback=feedback,
                             tracer=tracer, probe=probe)

"""Named tenant collections: schema, engine, shards, manifest.

Port of ``repro/fleet/collections.py``.  ``Fleet.create`` builds each
tenant's engine on ``EngineConfig.device`` (the card by default), and
``save``/``restore`` go through the port's
:class:`~repro_torch.ckpt.Checkpointer`, whose directories the reference
reads too.

The redisvl idiom: a collection is declared by a small schema (index
name + typed fields + serving attributes), and the server owns the
engine objects behind it.  Here every :class:`TenantCollection` wraps
its OWN :class:`FilteredANNEngine` inside a :class:`ShardedANNEngine` —
so the predicate cache, plan cache, planner state, and live-corpus
generations are partitioned per tenant by construction (a noisy
tenant's cache churn cannot evict a quiet tenant's hot predicates), and
the autoscaler can repartition one tenant's shards without touching the
others.

:class:`Fleet` is the registry: create/drop/look up collections, track
the shared shard budget, snapshot every tenant's mutable state through
one ``repro_torch.ckpt.Checkpointer`` step whose manifest ``meta`` records
per-tenant generations and shard assignments (the fleet manifest).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.engine import EngineConfig, FilteredANNEngine
from ..runtime.queue import SLO_TIERS
from ..serve.engine import ShardedANNEngine

__all__ = ["FieldSpec", "CollectionSchema", "TenantCollection", "Fleet"]


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One typed attribute column: ``tag`` columns live in the categorical
    matrix, ``numeric`` columns in the numeric matrix (schema order maps
    to column order within each matrix)."""

    name: str
    kind: str                   # "tag" | "numeric"

    def __post_init__(self):
        if self.kind not in ("tag", "numeric"):
            raise ValueError(f"field kind must be tag|numeric, got {self.kind!r}")


@dataclasses.dataclass
class CollectionSchema:
    """Declarative description of one tenant collection.

    ``weight`` is the fair-share weight the deficit round-robin batcher
    honours; ``n_shards`` is the tenant's BASELINE shard assignment (the
    autoscaler moves the live count, ``Fleet.reset_shards`` returns to
    this); ``admit_rate``/``admit_burst`` configure the tenant's token
    bucket (None defers to the controller's defaults)."""

    name: str
    dim: int
    fields: Tuple[FieldSpec, ...] = ()
    slo_tier: str = "standard"
    weight: float = 1.0
    n_shards: int = 1
    admit_rate: Optional[float] = None
    admit_burst: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        if not self.name:
            raise ValueError("collection name must be non-empty")
        if self.dim < 1:
            raise ValueError(f"dim must be >= 1, got {self.dim}")
        if self.slo_tier not in SLO_TIERS:
            raise ValueError(
                f"unknown slo_tier {self.slo_tier!r} (one of {sorted(SLO_TIERS)})")
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        self.fields = tuple(
            f if isinstance(f, FieldSpec) else FieldSpec(**f) for f in self.fields)

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CollectionSchema":
        """redisvl-style schema dict::

            {"index": {"name": "products", "slo_tier": "interactive"},
             "fields": [{"name": "embedding", "type": "vector",
                         "attrs": {"dims": 64}},
                        {"name": "brand", "type": "tag"},
                        {"name": "price", "type": "numeric"}]}

        The ``vector`` field supplies ``dim``; ``tag``/``numeric`` fields
        become :class:`FieldSpec` columns in declaration order."""
        index = dict(d.get("index", {}))
        dim = index.pop("dim", 0)
        fields: List[FieldSpec] = []
        for f in d.get("fields", ()):
            kind = f.get("type", f.get("kind"))
            if kind == "vector":
                dim = int(f.get("attrs", {}).get("dims", dim))
                continue
            fields.append(FieldSpec(f["name"], kind))
        return cls(dim=int(dim), fields=tuple(fields), **index)

    @property
    def tag_fields(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields if f.kind == "tag")

    @property
    def numeric_fields(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields if f.kind == "numeric")

    @property
    def deadline(self) -> float:
        return SLO_TIERS[self.slo_tier]

    def validate_rows(self, vectors: np.ndarray, cat: np.ndarray,
                      num: np.ndarray) -> None:
        """Corpus arrays must match the declared schema — width mismatches
        are caught at collection creation, not at first query."""
        v = np.atleast_2d(vectors)
        if v.shape[1] != self.dim:
            raise ValueError(
                f"{self.name}: vectors have dim {v.shape[1]}, schema says {self.dim}")
        if self.fields:
            c, m = np.atleast_2d(cat), np.atleast_2d(num)
            if c.shape[1] != len(self.tag_fields):
                raise ValueError(
                    f"{self.name}: {c.shape[1]} tag columns vs schema fields "
                    f"{self.tag_fields}")
            if m.shape[1] != len(self.numeric_fields):
                raise ValueError(
                    f"{self.name}: {m.shape[1]} numeric columns vs schema "
                    f"fields {self.numeric_fields}")


class TenantCollection:
    """One tenant: schema + engine + sharded serving face.

    The flat engine holds planning state and the live corpus; the
    :class:`ShardedANNEngine` wrapper is what serving traffic hits
    (plan once, fan out, exact merge) and what the autoscaler reshards."""

    def __init__(self, schema: CollectionSchema, engine: FilteredANNEngine,
                 backend: Optional[ShardedANNEngine] = None):
        self.schema = schema
        self.engine = engine
        self.backend = backend or ShardedANNEngine(engine, n_shards=schema.n_shards)

    # -- identity ------------------------------------------------------
    @property
    def name(self) -> str:
        return self.schema.name

    @property
    def slo_tier(self) -> str:
        return self.schema.slo_tier

    @property
    def weight(self) -> float:
        return self.schema.weight

    @property
    def n_shards(self) -> int:
        return len(self.backend.shards)

    # -- serving passthroughs ------------------------------------------
    def query(self, q, pred, k: int = 10):
        return self.backend.query(q, pred, k)

    def batch_query(self, queries, preds, k: int = 10):
        return self.backend.batch_query(queries, preds, k)

    def upsert(self, vectors, cat, num, ids=None):
        return self.backend.upsert(vectors, cat, num, ids=ids)

    def delete(self, ids):
        return self.backend.delete(ids)

    def maybe_compact(self):
        return self.backend.maybe_compact()

    def reshard(self, n_shards: int) -> "TenantCollection":
        self.backend.reshard(n_shards)
        return self

    # ------------------------------------------------------------------
    def manifest(self) -> Dict[str, Any]:
        """The per-tenant slice of the fleet manifest: which corpus
        version and planner head a snapshot captured, on how many shards."""
        return {
            "corpus_generation": int(getattr(self.engine, "corpus_generation", 0)),
            "planner_version": int(getattr(self.engine, "planner_version", 0)),
            "n_shards": self.n_shards,
            "slo_tier": self.slo_tier,
            "weight": self.weight,
            "n_total": int(self.engine.live.n_total),
            "live_count": int(self.engine.live.live_count),
        }

    def stats(self) -> Dict[str, Any]:
        out = self.backend.stats()
        out["schema"] = {
            "name": self.name, "dim": self.schema.dim,
            "slo_tier": self.slo_tier, "weight": self.weight,
            "n_shards": self.n_shards,
            "fields": [(f.name, f.kind) for f in self.schema.fields],
        }
        return out


class Fleet:
    """Registry of tenant collections sharing one machine's shard budget."""

    def __init__(self, total_shards: int = 8):
        if total_shards < 1:
            raise ValueError(f"total_shards must be >= 1, got {total_shards}")
        self.total_shards = total_shards
        self._cols: Dict[str, TenantCollection] = {}

    # -- registry ------------------------------------------------------
    def create(
        self,
        schema: CollectionSchema,
        vectors: np.ndarray,
        cat: np.ndarray,
        num: np.ndarray,
        config: Optional[EngineConfig] = None,
        train: Optional[Tuple[Sequence[np.ndarray], Sequence[Any]]] = None,
        k: int = 10,
    ) -> TenantCollection:
        """Build a tenant collection over its own corpus.  ``train`` is an
        optional ``(queries, predicates)`` pair for :meth:`FilteredANNEngine.fit`
        (the planner is per-tenant too — one tenant's workload never warps
        another's routing head)."""
        if schema.name in self._cols:
            raise ValueError(f"collection {schema.name!r} already exists")
        schema.validate_rows(vectors, cat, num)
        cfg = config or EngineConfig(seed=schema.seed)
        engine = FilteredANNEngine(vectors, cat, num, cfg).build()
        if train is not None:
            engine.fit(train[0], train[1], k=k)
        col = TenantCollection(schema, engine)
        if self.shards_in_use + col.n_shards > self.total_shards:
            raise ValueError(
                f"creating {schema.name!r} with {col.n_shards} shards exceeds "
                f"the fleet budget ({self.shards_in_use}/{self.total_shards} in use)")
        self._cols[schema.name] = col
        return col

    def add(self, col: TenantCollection) -> TenantCollection:
        """Register a pre-built collection (tests, restored fleets)."""
        if col.name in self._cols:
            raise ValueError(f"collection {col.name!r} already exists")
        self._cols[col.name] = col
        return col

    def drop(self, name: str) -> None:
        del self._cols[name]

    def __getitem__(self, name: str) -> TenantCollection:
        return self._cols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __iter__(self) -> Iterator[TenantCollection]:
        return iter(self._cols.values())

    def __len__(self) -> int:
        return len(self._cols)

    def names(self) -> List[str]:
        """Creation-ordered tenant names — the fixed round-robin order the
        fair-share batcher and autoscaler iterate in (determinism)."""
        return list(self._cols)

    @property
    def shards_in_use(self) -> int:
        return sum(c.n_shards for c in self._cols.values())

    def reset_shards(self) -> None:
        """Return every tenant to its schema-baseline shard assignment —
        how a replay starts from the same placement the first run did."""
        for col in self._cols.values():
            if col.n_shards != col.schema.n_shards:
                col.reshard(col.schema.n_shards)

    # -- manifest + checkpointing --------------------------------------
    def manifest(self) -> Dict[str, Any]:
        return {"tenants": {n: c.manifest() for n, c in self._cols.items()},
                "total_shards": self.total_shards}

    def save(self, ckpt, step: int) -> None:
        """One checkpoint step for the whole fleet: every tenant's mutable
        corpus state as a nested pytree, the fleet manifest in ``meta``."""
        tree = {n: c.engine.mutation_state() for n, c in self._cols.items()}
        ckpt.save(step, tree, meta={"fleet": self.manifest()})

    def restore(self, ckpt, step: Optional[int] = None) -> Dict[str, Any]:
        """Restore mutation state onto freshly-built collections over the
        same base corpora (per-engine ``load_mutation_state`` semantics),
        then reshard each tenant to the manifest's assignment so shard
        locators see the replayed segment + tombstones.  Returns the
        restored fleet manifest."""
        step = ckpt.latest_step() if step is None else step
        if step is None:
            raise ValueError("no checkpoint steps to restore from")
        meta = ckpt.read_meta(step).get("fleet", {})
        tenants = meta.get("tenants", {})
        missing = [n for n in self._cols if n not in tenants]
        if missing:
            raise ValueError(f"checkpoint manifest missing tenants: {missing}")
        template = {n: c.engine.mutation_state() for n, c in self._cols.items()}
        tree = ckpt.restore(step, template)
        for n, col in self._cols.items():
            col.engine.load_mutation_state(
                {k: np.asarray(v) for k, v in tree[n].items()})
            col.reshard(int(tenants[n].get("n_shards", col.schema.n_shards)))
        return meta

    def stats(self) -> Dict[str, Any]:
        return {n: c.stats() for n, c in self._cols.items()}

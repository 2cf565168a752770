"""State carried across from the JAX package, as plain numpy arrays.

Some state cannot be reproduced in torch: the planner's ``jax.random``
init, the order of k-means' segment sums, and the wall-clock races that
label planner training data.  To hold the port against the reference on
the same computation, these functions build the port's objects from the
reference's state, given as numpy arrays (this module imports neither jax
nor ``repro``; it reads plain attributes and arrays):

* the planner ``state_dict()`` (``params`` w1..b3, ``mu``, ``sigma``,
  ``meta``, optional ``route``) -> :func:`planner_from_state`;
* a fitted GBM (``base_`` and each tree's nodes) -> :func:`gbm_state`,
  :func:`gbm_from_state`;
* IVF centroids and assignment, which give the same ``sorted_ids`` /
  ``offsets`` layout -> :func:`ivf_from_assignment`;
* the LM's parameter tree (``Model.init(jax.random.PRNGKey(0))``) ->
  :func:`model_params_from_reference`, and the RAG server's projection ->
  :func:`retrieval_server`.

:func:`install` puts the first three into a built engine.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .core.gbm import GradientBoostingRegressor, RegressionTree, _Node
from .core.planner import CorePlanner
from .device import DEFAULT_DEVICE
from .index.ivf import IVFIndex
from .models.model import Model
from .serve.retrieval import RetrievalAugmentedServer

__all__ = ["gbm_state", "gbm_from_state", "planner_from_state",
           "ivf_from_assignment", "install", "model_params_from_reference",
           "retrieval_server"]

_NODE_FIELDS = ("feature", "threshold", "left", "right", "value")


def gbm_state(model) -> Dict:
    """A fitted GBM (either package's) as numpy arrays: ``base``,
    ``learning_rate`` and one (n_nodes, 5) float64 array per tree whose
    columns are feature, threshold, left, right, value."""
    trees = [
        np.asarray([[getattr(nd, f) for f in _NODE_FIELDS] for nd in t.nodes],
                   np.float64).reshape(-1, len(_NODE_FIELDS))
        for t in model.trees_
    ]
    return {"base": float(model.base_), "learning_rate": float(model.learning_rate),
            "max_depth": int(model.max_depth), "trees": trees}


def gbm_from_state(state: Dict) -> GradientBoostingRegressor:
    model = GradientBoostingRegressor(max_depth=state["max_depth"],
                                      learning_rate=state["learning_rate"])
    model.base_ = float(state["base"])
    model.trees_ = []
    for arr in state["trees"]:
        tree = RegressionTree(max_depth=state["max_depth"])
        tree.nodes = [
            _Node(feature=int(r[0]), threshold=float(r[1]), left=int(r[2]),
                  right=int(r[3]), value=float(r[4]))
            for r in np.asarray(arr, np.float64)
        ]
        model.trees_.append(tree)
    return model


def planner_from_state(state: Dict, device=DEFAULT_DEVICE) -> CorePlanner:
    meta = np.asarray(state["meta"])
    planner = CorePlanner(n_features=int(meta[0]), seed=int(meta[1]), device=device)
    return planner.load_state(state)


def ivf_from_assignment(vectors, centroids: np.ndarray, assignment: np.ndarray,
                        seed: int = 0, device=DEFAULT_DEVICE) -> IVFIndex:
    ivf = IVFIndex(vectors, n_lists=int(np.asarray(centroids).shape[0]), seed=seed,
                   device=device)
    return ivf.set_layout(np.array(centroids, np.float32),
                          np.array(assignment, np.int64))


def install(engine, *, centroids: Optional[np.ndarray] = None,
            assignment: Optional[np.ndarray] = None,
            gbm: Optional[Dict] = None, planner: Optional[Dict] = None):
    """Put carried state into a built engine: the IVF layout (behind the
    post-filter executor), the estimator's GBM and the planner head.  The
    plan cache is emptied, as a refit would."""
    if centroids is not None:
        engine.ivf = ivf_from_assignment(engine.vectors_dev, centroids, assignment,
                                         seed=engine.config.seed, device=engine.device)
        engine.post_exec.index = engine.ivf
    if gbm is not None:
        engine.estimator.model = gbm_from_state(gbm)
        engine.estimator.generation += 1
    if planner is not None:
        engine.planner = planner_from_state(planner, device=engine.device)
        engine.planner_version += 1
    engine.plan_cache.clear()
    return engine


def model_params_from_reference(cfg, params: Dict, device=DEFAULT_DEVICE) -> Model:
    """The port's :class:`Model` holding the reference's weights.

    ``params`` is the reference's tree as numpy arrays (``jax.tree.map(
    np.asarray, params)``).  Its ``layers`` subtree is stacked on a leading
    layer axis (the reference inits layers with ``jax.vmap``); layer i of
    the port gets row i.  Every array is cast to ``cfg.dtype`` on loading.
    """
    model = Model(cfg, device=device)
    state = {"embed": params["embed"], "final_ln": params["final_ln"]}
    if not cfg.tie_embeddings:
        state["lm_head"] = params["lm_head"]
    for path, arr in _flatten(params["layers"]):
        arr = np.asarray(arr)
        if arr.shape[0] != cfg.n_layers:
            raise ValueError(f"layers.{path}: leading axis {arr.shape[0]} != {cfg.n_layers} layers")
        for i in range(cfg.n_layers):
            state[f"layers.{i}.{path}"] = arr[i]
    own = model.state_dict()
    if set(state) != set(own):
        raise ValueError(f"parameter names differ: reference-only {sorted(set(state) - set(own))}, "
                         f"port-only {sorted(set(own) - set(state))}")
    with torch.no_grad():
        for name, arr in state.items():
            arr = np.array(arr, np.float32)          # a writable copy
            if tuple(arr.shape) != tuple(own[name].shape):
                raise ValueError(f"{name}: shape {arr.shape} != {tuple(own[name].shape)}")
            own[name].copy_(torch.from_numpy(arr))
    return model


def _flatten(tree: Dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def retrieval_server(model: Model, ann, proj: np.ndarray) -> RetrievalAugmentedServer:
    """The port's RAG server with the reference's projection (its ``proj``,
    drawn from ``jax.random.PRNGKey(0)``), so both embed a prompt alike."""
    return RetrievalAugmentedServer(model, ann, proj=np.array(proj, np.float32))

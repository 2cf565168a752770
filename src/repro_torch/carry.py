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
* an IVF-PQ index's layout (``centroids``, ``sorted_ids``, ``offsets``,
  ``codebooks``, ``codes``, ``radius_sq``) and an ACORN graph
  (``neighbors``, ``seeds``, ``entry``) -> :func:`ivfpq_state`,
  :func:`acorn_state`, installed with ``IVFPQIndex.set_state`` /
  ``AcornIndex.set_state``;
* per-shard IVF layouts (centroids and assignment of each shard) ->
  :func:`shard_ivf_layouts`, :func:`install_shard_ivfs`;
* a live corpus' ``mutation_state()`` tree (either package's) ->
  :func:`mutation_tree`, which ``load_mutation_state`` of either package
  takes;
* the LM's parameter tree (``Model.init(jax.random.PRNGKey(0))``) ->
  :func:`model_params_from_reference`, and back (weights or grads) ->
  :func:`params_to_reference`; a training state (``TrainState``: params,
  the optimizer's step and moments) both ways ->
  :func:`train_state_from_reference`, :func:`train_state_to_reference`
  (whole tensors in the reference's layout: ``launch.train.
  make_sharded_train_step`` places a carried state onto any mesh, and
  ``launch.train.full_state`` makes a state sharded on one whole before
  it is carried back);
  the RAG server's projection -> :func:`retrieval_server`.

:func:`install` puts the first five into a built engine.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .core.gbm import GradientBoostingRegressor, RegressionTree, _Node
from .core.planner import CorePlanner
from .device import DEFAULT_DEVICE
from .index.ivf import IVFIndex
from .models.model import Model
from .serve.retrieval import RetrievalAugmentedServer
from .train.optimizer import AdamWState
from .train.train_step import TrainState

__all__ = ["gbm_state", "gbm_from_state", "planner_from_state",
           "ivf_from_assignment", "ivf_assignment", "ivfpq_state", "acorn_state",
           "install", "shard_ivf_layouts", "install_shard_ivfs", "mutation_tree",
           "model_params_from_reference", "params_to_reference", "train_state_from_reference",
           "train_state_to_reference", "retrieval_server"]

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


def ivf_assignment(index) -> np.ndarray:
    """Row -> list assignment (N,) of an IVF index's sorted layout (either
    package's: ``sorted_ids`` and host ``offsets``)."""
    sorted_ids = _array(index.sorted_ids)
    assign = np.empty(sorted_ids.size, np.int64)
    for lst in range(len(index.offsets) - 1):
        assign[sorted_ids[index.offsets[lst]:index.offsets[lst + 1]]] = lst
    return assign


_PQ_FIELDS = ("centroids", "sorted_ids", "offsets", "codebooks", "codes", "radius_sq")


def _array(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def ivfpq_state(index) -> Dict[str, np.ndarray]:
    """An IVF-PQ index's built layout (either package's) as numpy arrays."""
    return {f: _array(getattr(index, f)) for f in _PQ_FIELDS}


def acorn_state(index) -> Dict:
    """An ACORN index's graph (either package's) as numpy arrays."""
    return {"neighbors": _array(index.neighbors), "seeds": _array(index.seeds),
            "entry": int(index.entry)}


def install(engine, *, centroids: Optional[np.ndarray] = None,
            assignment: Optional[np.ndarray] = None,
            gbm: Optional[Dict] = None, planner: Optional[Dict] = None,
            backend_ivf: Optional[np.ndarray] = None,
            ivfpq: Optional[Dict] = None, acorn: Optional[Dict] = None):
    """Put carried state into a built engine: the IVF layout (behind the
    post-filter executor), the estimator's GBM, the planner head (with its
    routing head, if it has one), and into the engine's BackendSet the
    ``ivf`` backend's layout (``backend_ivf``: centroids and assignment),
    the ``ivfpq`` layout and the ``acorn`` graph.  An ``ivf`` backend that
    shares the engine's IVF follows it, and gets a layout of its own only
    when ``backend_ivf`` differs from the engine's.  The plan cache is
    emptied, as a refit would."""
    backends = engine.backend_set.backends if engine.backend_set is not None else {}
    ivf_backend = backends.get("ivf")
    shared = ivf_backend is not None and ivf_backend.index is engine.ivf
    if centroids is not None:
        engine.ivf = ivf_from_assignment(engine.vectors_dev, centroids, assignment,
                                         seed=engine.config.seed, device=engine.device)
        engine.post_exec.index = engine.ivf
        if shared:
            ivf_backend.index = engine.ivf
    if backend_ivf is not None:
        c, a = backend_ivf
        same = (np.array_equal(_array(engine.ivf.centroids), np.asarray(c, np.float32))
                and np.array_equal(ivf_assignment(engine.ivf), np.asarray(a, np.int64)))
        ivf_backend.index = engine.ivf if same else ivf_from_assignment(
            engine.vectors_dev, c, a, seed=engine.config.seed, device=engine.device)
    if ivfpq is not None:
        backends["ivfpq"].index.set_state(**ivfpq)
    if acorn is not None:
        backends["acorn"].index.set_state(**acorn)
    if gbm is not None:
        engine.estimator.model = gbm_from_state(gbm)
        engine.estimator.generation += 1
    if planner is not None:
        engine.planner = planner_from_state(planner, device=engine.device)
        engine.planner_version += 1
    engine.plan_cache.clear()
    return engine


def shard_ivf_layouts(shards) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(centroids, assignment) of each shard's post-filter IVF, in shard
    order (either package's ``CorpusShard`` list)."""
    return [(_array(s.post_exec.index.centroids), ivf_assignment(s.post_exec.index))
            for s in shards]


def install_shard_ivfs(shards, layouts) -> None:
    """Give each of the port's shards the IVF layout ``layouts[s]``
    (centroids, assignment); a shard's ``ivf`` backend that shared its old
    IVF follows it."""
    if len(layouts) != len(shards):
        raise ValueError(f"{len(layouts)} layouts for {len(shards)} shards")
    for s, (c, a) in zip(shards, layouts):
        old = s.post_exec.index
        s.post_exec.index = ivf_from_assignment(old.vectors, c, a, seed=old.seed,
                                                device=old.device)
        ivf_backend = (s.backend_set.backends.get("ivf")
                       if s.backend_set is not None else None)
        if ivf_backend is not None and ivf_backend.index is old:
            ivf_backend.index = s.post_exec.index


def mutation_tree(tree) -> Dict[str, np.ndarray]:
    """A ``mutation_state()`` tree (either package's) as numpy arrays with
    the reference's dtypes, for the other package's ``load_mutation_state``."""
    out = {k: _array(v) for k, v in tree.items()}
    out["base_n"] = np.asarray(out["base_n"], np.int64)
    out["generation"] = np.asarray(out["generation"], np.int64)
    out["tomb"] = np.asarray(out["tomb"], np.uint32)
    out["seg_vectors"] = np.asarray(out["seg_vectors"], np.float32)
    return out


def model_params_from_reference(cfg, params: Dict, device=DEFAULT_DEVICE) -> Model:
    """The port's :class:`Model` holding the reference's weights.

    ``params`` is the reference's tree as numpy arrays (``jax.tree.map(
    np.asarray, params)``).  Its ``layers`` subtree is stacked on a leading
    layer axis (the reference inits layers with ``jax.vmap``); layer i of
    the port gets row i, nested dicts by dotted names (an MoE layer's
    ``ffn.router``, ``ffn.w_gate`` (E, d, f), ``ffn.shared.w_up``; gemma2's
    post-norms ``ln1b``, ``ln2b``; a hybrid layer's ``mamba.a_log``).  An
    xLSTM's ``blocks`` subtree is stacked on the G groups, and its
    ``mlstm.*`` leaves on the every-1 mLSTMs of a group after that: group g
    gets ``blocks.<g>.slstm.*``, ``blocks.<g>.slstm_ln``,
    ``blocks.<g>.mlstm_ln`` (every-1, d) and ``blocks.<g>.mlstm.<j>.*``.
    An encdec model's ``enc_layers`` subtree is stacked on its encoder
    layers likewise (``enc_layers.<i>.attn.wq``), beside ``enc_final_ln``
    and its decoder layers' ``ln_x`` and ``xattn.*``.  Every array is cast to the type the port stores it in: ``cfg.dtype``,
    or fp32 for the recurrences' weights the reference uses uncast.
    """
    return _load(Model(cfg, device=device), params)


def _stacked(model: Model) -> Dict[str, int]:
    """The reference's layer-stacked subtrees of ``model``'s config, each
    with its count of stacked layers (an xLSTM's groups)."""
    cfg = model.cfg
    if cfg.family == "ssm":
        return {"blocks": len(model.blocks)}
    return {"layers": cfg.n_layers, **({"enc_layers": cfg.n_enc_layers} if cfg.is_encdec else {})}


def _by_name(params: Dict, stacked: Dict[str, int]) -> Dict[str, np.ndarray]:
    """The reference's nested, layer-stacked tree by the port's names."""
    state = {k: v for k, v in params.items() if k not in stacked}
    for root, n in stacked.items():
        for path, arr in _flatten(params[root]):
            arr = np.asarray(arr)
            if arr.shape[0] != n:
                raise ValueError(f"{root}.{path}: leading axis {arr.shape[0]} != {n}")
            for i in range(n):
                if path.startswith("mlstm."):
                    for j in range(arr.shape[1]):
                        state[f"{root}.{i}.mlstm.{j}.{path[6:]}"] = arr[i, j]
                else:
                    state[f"{root}.{i}.{path}"] = arr[i]
    return state


def _load(model: Model, params: Dict) -> Model:
    """Copy the reference's tree into ``model``'s weights, each cast to the
    type the model stores it in."""
    state = _by_name(params, _stacked(model))
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


def params_to_reference(model: Model, tensors: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict:
    """The inverse of :func:`model_params_from_reference`: ``model``'s
    weights (or ``tensors``, a dict by the same names: its grads, or an
    optimizer moment) as the reference's nested tree of numpy arrays, layer
    i stacked at row i of ``layers`` (an xLSTM's group g and mLSTM j at
    ``blocks`` [g] and [g, j]; an encdec model's encoder layer i at row i
    of ``enc_layers``).  Arrays keep their stored type."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    stacked = _stacked(model)
    rows: Dict[str, Dict[str, Dict[Tuple[int, ...], np.ndarray]]] = {r: {} for r in stacked}
    out: Dict = {}
    for name, t in tensors.items():
        arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        parts = name.split(".")
        if parts[0] not in stacked:
            out[name] = arr
        elif len(parts) > 4 and parts[2] == "mlstm":
            rows[parts[0]].setdefault(".".join(["mlstm"] + parts[4:]), {})[
                (int(parts[1]), int(parts[3]))] = arr
        else:
            rows[parts[0]].setdefault(".".join(parts[2:]), {})[(int(parts[1]),)] = arr
    for root, by_path in rows.items():
        tree: Dict = {}
        for path, by_at in by_path.items():
            ats = sorted(by_at)
            shape = tuple(max(a[d] for a in ats) + 1 for d in range(len(ats[0])))
            first = by_at[ats[0]]
            arr = np.empty(shape + first.shape, first.dtype)
            for at, a in by_at.items():
                arr[at] = a
            node = tree
            *dirs, leaf = path.split(".")
            for d in dirs:
                node = node.setdefault(d, {})
            node[leaf] = arr
        out[root] = tree
    return out


def train_state_to_reference(model: Model, state: TrainState) -> TrainState:
    """A port ``TrainState`` as the reference's: params and the moments
    ``m``, ``v`` as :func:`params_to_reference` trees, ``step`` a 0-d
    int32 array.  Its fields have the reference's names, so a
    ``Checkpointer`` of either package saves it under the reference's keys
    (``.params/...``, ``.opt/.step``, ``.opt/.m/...``).  ``state`` holds
    whole tensors: a state sharded on a mesh (``make_sharded_train_step``'s)
    is made whole first, by ``launch.train.full_state``."""
    return TrainState(
        params=params_to_reference(model, state.params),
        opt=AdamWState(step=np.asarray(state.opt.step.cpu().numpy(), np.int32),
                       m=params_to_reference(model, state.opt.m),
                       v=params_to_reference(model, state.opt.v)))


def train_state_from_reference(cfg, state_np, device=DEFAULT_DEVICE,
                               model: Optional[Model] = None) -> Tuple[Model, TrainState]:
    """The inverse of :func:`train_state_to_reference`: a reference
    ``TrainState`` of numpy arrays (``jax.tree.map(np.asarray, state)``, or
    a restored checkpoint's tree) -> (a trainable :class:`Model` holding
    its params, a port ``TrainState`` over that model's parameters, its
    moments fp32 on ``device``).  With ``model`` the params are copied into
    it (made trainable first) instead of into a new one; it must hold
    whole weights (``make_sharded_train_step`` then places the state onto
    a mesh)."""
    if model is not None and model.model_axis is not None:
        raise ValueError("a model cut over a model axis takes no whole state: load it into "
                         "a whole model, then place both with make_sharded_train_step")
    if model is None:
        model = Model(cfg, device=device)
    _load(model.trainable(), state_np.params)
    dev = model.device
    stacked = _stacked(model)

    def moments(tree) -> Dict[str, torch.Tensor]:
        return {k: torch.tensor(np.asarray(a, np.float32), device=dev)
                for k, a in _by_name(tree, stacked).items()}

    opt = AdamWState(step=torch.tensor(int(np.asarray(state_np.opt.step)), dtype=torch.int32,
                                       device=dev),
                     m=moments(state_np.opt.m), v=moments(state_np.opt.v))
    return model, TrainState(params=dict(model.named_parameters()), opt=opt)


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

"""A whole run on the CPU with the timed path broken underneath: ``correct``
has to come out false for each fault a cell can have, and true without one.
The control (the reference in TF32 in the program's place) has to fail too."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import harness
from bench.control import control_readings

QUIET = dict(device="cpu", log=lambda *a: None)


def _run(root, fault=None, cell="tiny.mixed", seed=4242):
    return harness.run_cell(cell, seed, 0.4, False, root=root, fault=fault, **QUIET)


def _force_post(eng):
    """Plan every row post (the IVF path), whatever the planner says."""
    from repro_torch.core.planner import POST_FILTER

    def decide(preds, ests, exact, k):
        n = len(preds)
        return np.full(n, POST_FILTER, np.int32), np.full(n, -1, np.int32)

    eng._decide_clauses = decide
    eng.plan_cache.clear()


@pytest.mark.parametrize("cell", ["tiny.mixed", "tiny.pool"])
def test_sound_run_is_correct(tiny_root, cell):
    r = _run(tiny_root, cell=cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert 0.99 <= r["metrics"]["recall_at_10"]["value"] <= 1.0
    r = _run(tiny_root, fault=_force_post, cell=cell)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("all_post", [False, True], ids=["planned", "all_post"])
def test_half_of_each_batch_left_out(tiny_root, all_post):
    """Caught on exact rows by ``exact_short_rows``; where every row is
    planned post, as in an all-post cell, by ``short_share`` alone."""
    def fault(eng):
        if all_post:
            _force_post(eng)
        inner = eng.batch_query

        def batch_query(queries, preds, k=10):
            out = inner(queries, preds, k)
            for r in out[len(out) // 2:]:
                r.result.ids = np.full_like(r.result.ids, -1)
                r.result.dists = np.full_like(r.result.dists, np.inf)
            return out
        eng.batch_query = batch_query

    r = _run(tiny_root, fault)
    assert not r["correct"]
    checks = r["checks"]
    assert checks["short_share"]["value"] > checks["short_share"]["limit"]
    assert (checks["exact_short_rows"]["value"] == 0) == all_post


def test_answer_altered_in_the_kernel(tiny_root):
    from repro_torch.core import executors

    real = executors.fused_masked_topk

    def altered(q, x, m, k):
        d, ids = real(q, x, m, k)
        ids = ids.clone()
        ids[:, 0] = torch.where(ids[:, 0] >= 0, (ids[:, 0] + 1) % x.shape[0], ids[:, 0])
        return d, ids

    def fault(eng):
        executors.fused_masked_topk = altered

    try:
        r = _run(tiny_root, fault)
    finally:
        executors.fused_masked_topk = real
    assert not r["correct"]
    assert r["checks"]["invalid_ids"]["value"] > 0 or r["checks"]["dist_err"]["value"] > \
        r["checks"]["dist_err"]["limit"]


def test_answer_altered_in_the_ivf_path(tiny_root):
    def fault(eng):
        _force_post(eng)
        real = eng.ivf.search

        def search(queries, k, nprobe=8, mask=None):
            d, ids = real(queries, k, nprobe=nprobe, mask=mask)
            ids = ids.copy()
            ids[:, :] = np.where(ids >= 0, (ids + 1) % eng.ivf.n, ids)
            return d, ids
        eng.ivf.search = search

    r = _run(tiny_root, fault)
    assert not r["correct"]
    assert r["checks"]["invalid_ids"]["value"] > 0 or r["checks"]["dist_err"]["value"] > \
        r["checks"]["dist_err"]["limit"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails(tiny_root, seed):
    out = control_readings("tiny.mixed", seed, root=tiny_root, device="cpu")
    assert out["fails"], out
    assert out["numbers"]["dist_err"] > 10 * out["limits"]["dist_err"]

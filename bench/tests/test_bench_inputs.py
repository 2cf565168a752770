"""The generated inputs and the plain reference, on the CPU."""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from bench.corpus import generate, query_vectors
from bench.reference.exact import exact_topk, predicate_mask
from bench.traffic.generator import gen_predicate, make_predicates, to_program

from conftest import REPO, tiny_config

DIGEST = """
import hashlib, json, sys
sys.path[:0] = [{src!r}, {repo!r}]
import torch
from bench.corpus import generate, query_vectors
cfg = json.loads(sys.argv[1])
c = generate(cfg, int(sys.argv[2]), "cpu")
q = query_vectors(c, 64, 0.05, 5)
h = hashlib.sha256()
for t in (c.vectors, c.cat, c.num):
    h.update(t.numpy().tobytes())
h.update(q.tobytes())
print(h.hexdigest())
"""


def _digest(cfg: dict, seed: int) -> str:
    code = DIGEST.format(src=str(REPO / "src"), repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", code, json.dumps(cfg), str(seed)],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def test_generator_same_in_two_processes_and_seed_dependent():
    cfg = tiny_config("wolt-1.7m")
    big = 2**31 + 12345
    a, b, c = _digest(cfg, big), _digest(cfg, big), _digest(cfg, big + 1)
    assert a == b
    assert a != c


def test_generator_shapes_and_distributions():
    cfg = tiny_config("arxiv-2m")
    c = generate(cfg, 3, "cpu")
    assert c.vectors.shape == (cfg["rows"], cfg["dim"]) and c.vectors.dtype == torch.float32
    assert c.cat.shape == (cfg["rows"], 3) and c.cat.dtype == torch.int32
    for j, spec in enumerate(cfg["categorical"]):
        assert 0 <= int(c.cat[:, j].min()) and int(c.cat[:, j].max()) < spec["codes"]
    year = c.num[:, 0]
    assert 1995 < float(year.mean()) < 2020
    assert float(c.num[:, 1].min()) > 0                       # lognormal
    w = tiny_config("wolt-1.7m")
    cw = generate(w, 3, "cpu")
    assert float(cw.num[:, 2].min()) >= 1.0 and float(cw.num[:, 2].max()) <= 10.0
    assert abs(float(cw.num[:, 1].mean()) - 30.0) < 3.0          # gamma(6, 5)


def _np_mask(pred, cat, num):
    labels, ranges = pred
    m = np.ones(cat.shape[0], bool)
    for a, code in labels:
        m &= cat[:, a] == code
    for a, ivs in ranges:
        r = np.zeros_like(m)
        for lo, hi in ivs:
            r |= (num[:, a] >= np.float32(lo)) & (num[:, a] < np.float32(hi))
        m &= r
    return m


def test_reference_predicates_and_topk_against_brute_force():
    cfg = tiny_config("arxiv-2m")
    c = generate(cfg, 9, "cpu")
    cat, num, x = c.cat.numpy(), c.num.numpy(), c.vectors.numpy()
    sorted_num = [np.sort(num[:, j]) for j in range(num.shape[1])]
    rng = np.random.default_rng(0)
    preds = [gen_predicate(cat, num, sorted_num, 0.05, kind, rng, 0.5)
             for kind in ("range", "label", "mixed") for _ in range(8)]
    preds.append(((), ((0, ((1e9, 2e9),)),)))                 # passes nothing
    q = query_vectors(c, len(preds), 0.05, 1)
    masks = torch.stack([predicate_mask(p, c.cat, c.num) for p in preds])
    prog = to_program(preds)
    for p, pp, m in zip(preds, prog, masks):
        assert np.array_equal(m.numpy(), _np_mask(p, cat, num))
        assert np.array_equal(m.numpy(), pp.eval(cat, num))     # the program's semantics
    d64, ids = exact_topk(torch.as_tensor(q), c.vectors, (c.vectors ** 2).sum(1), masks, 10)
    for i, p in enumerate(preds):
        rows = np.flatnonzero(masks[i].numpy())
        dd = ((x[rows].astype(np.float64) - q[i].astype(np.float64)) ** 2).sum(1)
        order = np.lexsort((rows, dd))[:10]
        want = np.full(10, -1)
        want[:order.size] = rows[order]
        assert np.array_equal(ids[i].numpy(), want)
        assert np.allclose(d64[i].numpy()[:order.size], dd[order], rtol=0, atol=1e-9)


def test_fresh_predicates_unique():
    cfg = tiny_config("wolt-1.7m")
    c = generate(cfg, 2, "cpu")
    cat, num = c.cat.numpy(), c.num.numpy()
    sorted_num = [np.sort(num[:, j]) for j in range(num.shape[1])]
    spec = {"mode": "fresh", "kinds": ["range"], "pass_fraction": [0.01, 0.25],
            "multi_range_prob": 0.2, "unique": True}
    ps = make_predicates(spec, cat, num, sorted_num, 2000, 4)
    assert len(set(ps)) == 2000 and ps == make_predicates(spec, cat, num, sorted_num, 2000, 4)
    frac = np.array([_np_mask(p, cat, num).mean() for p in ps])
    assert (frac > 0).mean() > 0.99 and 0.01 < np.median(frac) < 0.25


def test_pool_has_the_same_sizes_for_every_seed():
    pool = json.loads((REPO / "bench" / "traffic" / "popular-labels.json").read_text())
    pool = pool["predicates"]
    cfg = dict(tiny_config("arxiv-2m"), rows=100_000)
    by_rank = []
    for seed in (2, 3):
        c = generate(cfg, seed, "cpu")
        cat, num = c.cat.numpy(), c.num.numpy()
        sorted_num = [np.sort(num[:, j]) for j in range(num.shape[1])]
        ps = make_predicates(pool, cat, num, sorted_num, 20000, seed)
        counts = {}
        for p in ps:
            counts[p] = counts.get(p, 0) + 1
        ranked = sorted(counts, key=lambda p: -counts[p])
        assert len(ranked) == 48 and counts[ranked[0]] > 5 * counts[ranked[-1]]
        by_rank.append([_np_mask(p, cat, num).mean() for p in ranked[:8]])
    # the most requested predicates pass about the same share of rows in both
    a, b = np.log(np.maximum(by_rank, 1e-5))
    assert np.abs(a - b).max() < np.log(2.0)

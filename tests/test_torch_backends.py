"""The port's backend registry against the conformance contract and the
JAX package's backends, on the CPU.

The contract of tests/backend_conformance.py, parametrised over the port's
``DEFAULT_BACKENDS`` on the same clustered 5,000 x 32 corpus: recall floors
at every tier, bitwise row independence on a tie-heavy corpus, mask safety
without duplicates, empty / tiny / all-masked / fewer-survivors edges, the
sharded merge and the DNF union merge (bitwise at the exact tier), registry
mechanics, the IVF-PQ memory reduction, and every backend serving a
mutated corpus through ``LiveIndex`` (no tombstoned id, fresh upserts
found, exact tiers bit-identical to a fresh build after compaction).

Then parity with the reference on carried state (its k-means differs from
the port's, so layouts are loaded, not rebuilt): IVF-PQ tables and search,
ACORN's host search, ``search_torch``'s recall, and a routed engine whose
planner and routing head are the reference's.
"""
import numpy as np
import pytest

from repro.core import EngineConfig as RefConfig
from repro.core import FilteredANNEngine as RefEngine
from repro.core import Or as RefOr
from repro.core import trainer as ref_trainer
from repro.index import make_backend as ref_make_backend
from repro_torch import carry
from repro_torch.core import EngineConfig, FilteredANNEngine, LiveCorpus, Or, gen_queries
from repro_torch.data import make_dataset
from repro_torch.dist.collectives import merge_topk, merge_topk_unique
from repro_torch.index import (
    BackendSet,
    LiveIndex,
    make_backend,
    register_backend,
    unregister_backend,
)
from repro_torch.index.registry import (
    DEFAULT_BACKENDS,
    TINY_N,
    KnobTier,
    _exact_masked,
    backend_names,
)
from test_torch_engine import _same_up_to_ties, _threshold_head

K = 10
DEV = "cpu"


@pytest.fixture(scope="module")
def corpus():
    """Clustered corpus, near-duplicate queries and a 50 % mask."""
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 1, (16, 32)).astype(np.float32)
    x = (centers[rng.choice(16, 5000)] + 0.3 * rng.normal(0, 1, (5000, 32))).astype(
        np.float32
    )
    q = (x[rng.choice(5000, 20)] + 0.05 * rng.normal(0, 1, (20, 32))).astype(np.float32)
    mask = rng.random(5000) < 0.5
    return x, q, mask


@pytest.fixture(scope="module")
def built(corpus):
    x, _, _ = corpus
    return {nm: make_backend(nm, x, seed=0, device=DEV) for nm in DEFAULT_BACKENDS}


@pytest.fixture(scope="module")
def ref_built(corpus):
    x, _, _ = corpus
    return {nm: ref_make_backend(nm, x, seed=0) for nm in ("ivfpq", "acorn")}


def _recall(ids, truth_ids):
    got = 0
    for row, t in zip(ids, truth_ids):
        ts = set(int(v) for v in t if v >= 0)
        if ts:
            got += len(ts & set(int(v) for v in row if v >= 0)) / len(ts)
    return got / len(ids)


# ----------------------------------------------------------------------
# the conformance contract
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", DEFAULT_BACKENDS)
def test_recall_floor_every_tier(built, corpus, name):
    x, q, mask = corpus
    b = built[name]
    _, truth = _exact_masked(x, q, mask, K)
    for tier in b.knob_grid():
        _, ids = b.search_masked(q, mask, K, knobs=tier.knobs)
        r = _recall(ids, truth)
        assert r >= tier.recall_floor, f"{name}:{tier.name} recall {r:.3f} < {tier.recall_floor}"


@pytest.mark.parametrize("name", DEFAULT_BACKENDS)
def test_row_independence_with_ties(name):
    """Rounded coordinates force distance ties; every row is bitwise equal
    alone, batched and in a reversed batch."""
    rng = np.random.default_rng(3)
    x = np.round(rng.normal(0, 1, (600, 16)).astype(np.float32) * 2) / 2
    q = np.round(rng.normal(0, 1, (9, 16)).astype(np.float32) * 2) / 2
    mask = rng.random(600) < 0.6
    b = make_backend(name, x, seed=0, device=DEV)
    for tier in b.knob_grid():
        bd, bi = b.search_masked(q, mask, K, knobs=tier.knobs)
        for j in range(len(q)):
            sd, si = b.search_masked(q[j : j + 1], mask, K, knobs=tier.knobs)
            np.testing.assert_array_equal(si[0], bi[j], err_msg=f"{name}:{tier.name} solo row {j}")
            np.testing.assert_array_equal(sd[0], bd[j])
        rd, ri = b.search_masked(q[::-1].copy(), mask, K, knobs=tier.knobs)
        np.testing.assert_array_equal(ri[::-1], bi, err_msg=f"{name}:{tier.name} reversed")
        np.testing.assert_array_equal(rd[::-1], bd)


@pytest.mark.parametrize("name", DEFAULT_BACKENDS)
def test_mask_safety_and_no_duplicates(built, corpus, name):
    x, q, mask = corpus
    b = built[name]
    for tier in b.knob_grid():
        _, ids = b.search_masked(q, mask, K, knobs=tier.knobs)
        for row in ids:
            valid = row[row >= 0]
            assert mask[valid].all(), f"{name}:{tier.name} leaked a masked-out id"
            assert len(set(valid.tolist())) == len(valid), f"{name}:{tier.name} duplicate id"


@pytest.mark.parametrize("name", DEFAULT_BACKENDS)
def test_empty_corpus(name):
    b = make_backend(name, np.zeros((0, 8), np.float32), seed=0, device=DEV)
    q = np.random.default_rng(0).normal(0, 1, (3, 8)).astype(np.float32)
    d, i = b.search_masked(q, None, K)
    assert d.shape == (3, K) and i.shape == (3, K)
    assert (i == -1).all() and np.isinf(d).all()


@pytest.mark.parametrize("name", DEFAULT_BACKENDS)
def test_tiny_corpus_exact(name):
    """Below TINY_N every backend answers exactly, at every tier."""
    rng = np.random.default_rng(5)
    n = TINY_N - 10
    x = rng.normal(0, 1, (n, 12)).astype(np.float32)
    q = rng.normal(0, 1, (4, 12)).astype(np.float32)
    mask = rng.random(n) < 0.7
    want_d, want_i = _exact_masked(x, q, mask, K)
    b = make_backend(name, x, seed=0, device=DEV)
    for tier in b.knob_grid():
        d, i = b.search_masked(q, mask, K, knobs=tier.knobs)
        np.testing.assert_array_equal(i, want_i, err_msg=f"{name}:{tier.name}")
        np.testing.assert_allclose(d, want_d, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", DEFAULT_BACKENDS)
def test_tiny_corpus_exact_on_card(name):
    """Below TINY_N on the card every backend runs the masked L2 kernel
    (never the host scan), equal to the numpy scan up to exact ties."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    from repro_torch.kernels import ops

    rng = np.random.default_rng(5)
    for n in (1, 9, TINY_N - 1):
        x = rng.normal(0, 1, (n, 12)).astype(np.float32)
        q = rng.normal(0, 1, (4, 12)).astype(np.float32)
        mask = rng.random(n) < 0.7
        want_d, want_i = _exact_masked(x, q, mask, K)
        b = make_backend(name, x, seed=0, device="cuda")
        for tier in b.knob_grid():
            before = ops.kernel_launches()["masked_l2_topk"]
            d, i = b.search_masked(q, mask, K, knobs=tier.knobs)
            assert ops.kernel_launches()["masked_l2_topk"] == before + 1
            np.testing.assert_array_equal(i, want_i, err_msg=f"{name}:{tier.name} n={n}")
            np.testing.assert_allclose(d, want_d, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_lists", [None, 32])
def test_ivf_backend_shares_engine_ivf(n_lists):
    """The ivf backend takes the engine's IVF when its layout would be the
    same (default lists, same seed) and builds its own otherwise; carried
    layouts keep the sharing only where they agree."""
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2000, 16)).astype(np.float32)
    cat = rng.integers(0, 4, (2000, 2)).astype(np.int32)
    num = rng.random((2000, 1)).astype(np.float32)
    e = FilteredANNEngine(x, cat, num, EngineConfig(seed=0, device=DEV, n_lists=n_lists,
                                                    backends=("flat", "ivf"))).build()
    ivf_b = e.backend_set.backends["ivf"]
    assert (ivf_b.index is e.ivf) == (n_lists is None)
    assert ivf_b.index.n_lists == int(np.sqrt(2000))
    own = (ivf_b.index.centroids.numpy(), carry.ivf_assignment(ivf_b.index))
    assign = rng.integers(0, 8, 2000)
    cents = np.stack([x[assign == c].mean(0) for c in range(8)])
    carry.install(e, centroids=cents, assignment=assign)
    assert (ivf_b.index is e.ivf) == (n_lists is None)
    carry.install(e, backend_ivf=own)
    assert ivf_b.index is not e.ivf and ivf_b.index.n_lists == own[0].shape[0]
    carry.install(e, backend_ivf=(cents, assign))
    assert ivf_b.index is e.ivf


@pytest.mark.parametrize("name", DEFAULT_BACKENDS)
def test_all_masked(built, corpus, name):
    x, q, _ = corpus
    d, i = built[name].search_masked(q[:4], np.zeros(len(x), bool), K)
    assert (i == -1).all() and np.isinf(d).all()


@pytest.mark.parametrize("name", DEFAULT_BACKENDS)
def test_fewer_survivors_than_k(built, corpus, name):
    """|masked| <= k: exact tiers return exactly the survivors; every tier
    returns only survivors, -1/inf padded, without duplicates."""
    x, q, _ = corpus
    b = built[name]
    mask = np.zeros(len(x), bool)
    keep = np.random.default_rng(9).choice(len(x), 6, replace=False)
    mask[keep] = True
    keep_set = set(keep.tolist())
    for tier in b.knob_grid():
        d, ids = b.search_masked(q[:5], mask, K, knobs=tier.knobs)
        for dr, row in zip(d, ids):
            valid = [int(v) for v in row if v >= 0]
            assert set(valid) <= keep_set, f"{name}:{tier.name} leaked a non-survivor"
            assert len(set(valid)) == len(valid)
            assert np.isinf(dr[row == -1]).all()
            if tier.recall_floor >= 0.99:
                assert set(valid) == keep_set, f"{name}:{tier.name} (exact) missed a survivor"


@pytest.mark.parametrize("name", DEFAULT_BACKENDS)
def test_sharded_merge_identity(corpus, name):
    """Per-shard masked top-k merged with ``merge_topk`` equals the whole
    corpus bitwise at the exact tier, and keeps the floor elsewhere."""
    x, q, mask = corpus
    n_shards = 4
    bounds = np.linspace(0, len(x), n_shards + 1).astype(int)
    whole = make_backend(name, x, seed=0, device=DEV)
    shards = [make_backend(name, x[bounds[s]:bounds[s + 1]], seed=s, device=DEV)
              for s in range(n_shards)]
    _, truth = _exact_masked(x, q, mask, K)
    for tier in whole.knob_grid():
        wd, wi = whole.search_masked(q, mask, K, knobs=tier.knobs)
        ds_, is_ = [], []
        for s, shard in enumerate(shards):
            lo, hi = bounds[s], bounds[s + 1]
            sd, si = shard.search_masked(q, mask[lo:hi], K, knobs=tier.knobs)
            ds_.append(sd)
            is_.append(np.where(si >= 0, si + lo, -1).astype(np.int32))
        md, mi = merge_topk(np.stack(ds_), np.stack(is_), K)
        if tier.recall_floor >= 0.99:
            np.testing.assert_array_equal(mi, wi, err_msg=f"{name}:{tier.name}")
            np.testing.assert_array_equal(md, wd)
        else:
            r = _recall(mi, truth)
            assert r >= tier.recall_floor, f"sharded {name}:{tier.name} recall {r:.3f}"


@pytest.mark.parametrize("name", DEFAULT_BACKENDS)
def test_dnf_union_merge_identity(built, corpus, name):
    """Per-clause masked top-k merged with ``merge_topk_unique`` against one
    search over the union mask (the clause masks overlap): bitwise at the
    exact tier, the floor elsewhere, no duplicates at any tier."""
    x, q, _ = corpus
    rng = np.random.default_rng(21)
    clause_masks = [rng.random(len(x)) < 0.25 for _ in range(3)]
    union = clause_masks[0] | clause_masks[1] | clause_masks[2]
    assert (clause_masks[0] & clause_masks[1]).sum() > 0
    b = built[name]
    _, truth = _exact_masked(x, q, union, K)
    for tier in b.knob_grid():
        wd, wi = b.search_masked(q, union, K, knobs=tier.knobs)
        per = [b.search_masked(q, cm, K, knobs=tier.knobs) for cm in clause_masks]
        md, mi = merge_topk_unique(np.stack([d for d, _ in per]), np.stack([i for _, i in per]), K)
        for row in mi:
            valid = row[row >= 0]
            assert len(set(valid.tolist())) == len(valid), f"{name}:{tier.name} duplicate id"
            assert union[valid].all()
        if tier.recall_floor >= 0.99:
            np.testing.assert_array_equal(mi, wi, err_msg=f"{name}:{tier.name}")
            np.testing.assert_array_equal(md, wd)
        else:
            r = _recall(mi, truth)
            assert r >= tier.recall_floor, f"dnf-union {name}:{tier.name} recall {r:.3f}"


class _ToyExactBackend:
    """Minimal conforming backend: the exact numpy scan."""

    name = "toy"

    def __init__(self, seed: int = 0, device=DEV):
        self.seed = seed

    def build(self, corpus):
        self.vectors = np.ascontiguousarray(corpus, np.float32)
        return self

    def search_masked(self, queries, mask, k, knobs=None):
        return _exact_masked(self.vectors, queries, mask, k)

    def memory_bytes(self):
        return int(self.vectors.nbytes)

    def knob_grid(self):
        return (KnobTier("exact", {}, recall_floor=0.99),)


def test_register_unregister_custom_backend(corpus):
    x, q, mask = corpus
    register_backend("toy", _ToyExactBackend)
    try:
        assert "toy" in backend_names()
        with pytest.raises(ValueError):
            register_backend("toy", _ToyExactBackend)
        register_backend("toy", _ToyExactBackend, overwrite=True)
        want_d, want_i = _exact_masked(x, q, mask, K)
        _, i = make_backend("toy", x, seed=0, device=DEV).search_masked(q, mask, K)
        np.testing.assert_array_equal(i, want_i)
        bs = BackendSet.build(x, names=("toy", "flat"), seed=0, device=DEV)
        assert bs.class_names() == ("toy:exact", "flat:exact")
        _, si = bs.search_class(0, q, mask, K)
        np.testing.assert_array_equal(si, want_i)
        _, fi = bs.search_class(1, q, mask, K)
        np.testing.assert_array_equal(fi, want_i)
    finally:
        unregister_backend("toy")
    assert "toy" not in backend_names()
    with pytest.raises(KeyError):
        make_backend("toy", x, device=DEV)


def test_backendset_memory_and_pq_reduction(built, corpus):
    """IVF-PQ's scan-resident footprint is >= 4x smaller than flat's; the
    re-rank vectors are declared separately."""
    mem_flat = built["flat"].memory_bytes()
    mem_pq = built["ivfpq"].memory_bytes()
    assert mem_flat >= 4 * mem_pq, f"ivfpq memory {mem_pq} not >=4x smaller than flat {mem_flat}"
    assert built["ivfpq"].rerank_bytes == corpus[0].nbytes
    bs = BackendSet(dict(built))
    assert bs.memory_bytes() == {nm: b.memory_bytes() for nm, b in built.items()}
    assert len(bs.class_names()) == 8


# ----------------------------------------------------------------------
# mutate-then-search: every backend serves a live corpus via LiveIndex
# ----------------------------------------------------------------------
def _live_over(x, device=DEV):
    n = len(x)
    return LiveCorpus(x, np.zeros((n, 1), np.int32), np.zeros((n, 1), np.float32),
                      device=device)


def _wrap_attrs(rows):
    b = len(np.atleast_2d(rows))
    return np.zeros((b, 1), np.int32), np.zeros((b, 1), np.float32)


@pytest.mark.parametrize("name", DEFAULT_BACKENDS)
def test_mutate_delete_excludes_tombstones(built, corpus, name):
    """After deleting the oracle's own top hits, no tier surfaces a
    tombstoned id, and recall against the LIVE oracle clears each floor."""
    x, q, mask = corpus
    live = _live_over(x)
    b = LiveIndex(built[name], live)
    _, truth = _exact_masked(x, q, mask, K)
    dead = np.unique(truth[truth >= 0])[:40]
    live.delete(dead)
    live_mask = mask.copy()
    live_mask[dead] = False
    _, live_truth = _exact_masked(x, q, live_mask, K)
    for tier in b.knob_grid():
        _, ids = b.search_masked(q, mask, K, knobs=tier.knobs)
        valid = ids[ids >= 0]
        assert not np.isin(valid, dead).any(), f"{name}:{tier.name} surfaced a tombstoned id"
        assert mask[valid].all()
        r = _recall(ids, live_truth)
        assert r >= tier.recall_floor, f"{name}:{tier.name} live recall {r:.3f} < {tier.recall_floor}"


@pytest.mark.parametrize("name", DEFAULT_BACKENDS)
def test_mutate_upsert_returns_new_ids(built, corpus, name):
    """A just-upserted row at distance zero from its query surfaces at every
    tier: the segment is scanned exactly whatever the base backend is."""
    x, q, _ = corpus
    live = _live_over(x)
    b = LiveIndex(built[name], live)
    handles = live.upsert(q[:4], *_wrap_attrs(q[:4]))
    for tier in b.knob_grid():
        _, ids = b.search_masked(q[:4], None, K, knobs=tier.knobs)
        for j in range(4):
            assert handles[j] in ids[j], f"{name}:{tier.name} missed the fresh upsert (row {j})"


def test_live_index_on_card(corpus):
    """On the card LiveIndex over the flat backend launches the masked L2
    kernel once for the base and once for the segment, and equals one
    kernel scan of base + segment under the live mask bitwise, and the
    numpy scan up to exact ties."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    from repro_torch.kernels import fused_masked_topk, ops

    x, q, mask = corpus
    live = _live_over(x, device="cuda")
    b = LiveIndex(make_backend("flat", x, seed=0, device="cuda"), live)
    live.upsert(q[:4] + 0.01, *_wrap_attrs(q[:4]))
    live.upsert(x[:8], *_wrap_attrs(x[:8]))          # exact copies of base rows
    live.delete(np.arange(0, len(x), 7))
    m = np.concatenate([mask, np.ones(live.seg_n, bool)])
    before = ops.kernel_launches()["masked_l2_topk"]
    d, i = b.search_masked(q, m, K)
    assert ops.kernel_launches()["masked_l2_topk"] == before + 2
    keep = m & live.alive_mask()
    x_all = torch.cat([torch.as_tensor(x, device="cuda"), live.seg_vectors_dev()])
    wd, wi = fused_masked_topk(torch.as_tensor(q, device="cuda"), x_all,
                               torch.as_tensor(keep, device="cuda"), K)
    np.testing.assert_array_equal(i, wi.cpu().numpy())
    np.testing.assert_array_equal(d, wd.cpu().numpy())
    pd, pi = _exact_masked(np.concatenate([x, live.seg_vectors()]), q, keep, K)
    np.testing.assert_array_equal(i, pi)
    np.testing.assert_allclose(d, pd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", DEFAULT_BACKENDS)
def test_mutate_compaction_id_stable(built, corpus, name):
    """Exact tiers of the live view, translated through ``id_map``, equal a
    fresh build over the compacted corpus bit for bit (and the reference's
    LiveIndex up to ties, for flat); approximate tiers clear their floor
    against the compacted oracle."""
    from repro.core import LiveCorpus as RefLiveCorpus
    from repro.index import LiveIndex as RefLiveIndex

    x, q, mask = corpus
    live = _live_over(x)
    b = LiveIndex(built[name], live)
    rng = np.random.default_rng(11)
    dead = rng.choice(len(x), 60, replace=False)
    live.delete(dead)
    new_rows = (q[:6] + 0.01 * rng.normal(0, 1, (6, x.shape[1]))).astype(np.float32)
    live.upsert(new_rows, *_wrap_attrs(new_rows))
    lm = np.concatenate([mask, np.ones(live.seg_n, bool)])
    cv, _, _, id_map = live.compacted()
    alive_h = np.nonzero(id_map >= 0)[0]
    fm = np.zeros(len(cv), bool)
    fm[id_map[alive_h]] = lm[alive_h]
    fresh = make_backend(name, cv, seed=0, device=DEV)
    _, ctruth = _exact_masked(cv, q, fm, K)
    if name == "flat":
        rlive = RefLiveCorpus(x, *_wrap_attrs(x))
        rlive.delete(dead)
        rlive.upsert(new_rows, *_wrap_attrs(new_rows))
        rb = RefLiveIndex(ref_make_backend("flat", x, seed=0), rlive)
    for tier in b.knob_grid():
        ld, li = b.search_masked(q, lm, K, knobs=tier.knobs)
        tr = np.where(li >= 0, id_map[np.maximum(li, 0)], -1).astype(np.int32)
        if tier.recall_floor >= 0.99:
            fd, fi = fresh.search_masked(q, fm, K, knobs=tier.knobs)
            np.testing.assert_array_equal(tr, fi, err_msg=f"{name}:{tier.name}")
            np.testing.assert_array_equal(ld, fd)
        else:
            r = _recall(tr, ctruth)
            assert r >= tier.recall_floor, (
                f"{name}:{tier.name} post-compaction recall {r:.3f} < {tier.recall_floor}")
        if name == "flat":
            rd, ri = rb.search_masked(q, lm, K, knobs=tier.knobs)
            _same_up_to_ties(q, li, ld, np.asarray(ri), np.asarray(rd))


# ----------------------------------------------------------------------
# parity with the reference on carried state
# ----------------------------------------------------------------------
def _carried(name, corpus, ref_built):
    x, _, _ = corpus
    b = make_backend(name, x, seed=0, device=DEV)
    ix = ref_built[name].index
    if name == "ivfpq":
        b.index.set_state(**carry.ivfpq_state(ix))
    else:
        b.index.set_state(**carry.acorn_state(ix))
    return b


def test_pq_lut8_equal_on_carried_codebooks(corpus, ref_built):
    x, q, _ = corpus
    b = _carried("ivfpq", corpus, ref_built)
    ix, rix = b.index, ref_built["ivfpq"].index
    for qq in q:
        lut8, base, scale = ix._lut(qq)
        rlut8, rbase, rscale = rix._lut(qq)
        np.testing.assert_array_equal(lut8, rlut8)
        np.testing.assert_array_equal(base, rbase)
        assert scale == rscale
    ids = np.arange(0, len(x), 7)
    adc, bound = ix.adc_distances(q[0], ids)
    radc, rbound = rix.adc_distances(q[0], ids)
    np.testing.assert_array_equal(adc, radc)
    assert bound == rbound
    np.testing.assert_array_equal(ix.encode(x[:50]), rix.encode(x[:50]))
    np.testing.assert_allclose(ix.decode(ix.encode(x[:50])), rix.decode(rix.encode(x[:50])),
                               rtol=0, atol=0)


def test_pq_search_equals_reference_on_carried_state(corpus, ref_built):
    """Same ADC candidates; re-ranked distances within 1e-5 for equal ids,
    ids equal up to exact ties; raw ADC (rerank 0) bitwise."""
    x, q, mask = corpus
    b = _carried("ivfpq", corpus, ref_built)
    ref = ref_built["ivfpq"]
    for tier in b.knob_grid():
        d, i = b.search_masked(q, mask, K, knobs=tier.knobs)
        rd, ri = ref.search_masked(q, mask, K, knobs=tier.knobs)
        same = i == ri
        np.testing.assert_allclose(d[same], rd[same], rtol=1e-5, atol=1e-5)
        for r in range(len(q)):
            for da, ia, ib in zip(d[r], i[r], ri[r]):
                if ia != ib:
                    assert np.sum(np.abs(d[r] - da) <= 1e-5 * max(1.0, abs(da))) > 1, \
                        f"{tier.name} row {r}: {i[r]} vs {ri[r]}"
    d, i = b.index.search(q, K, nprobe=8, rerank=0, mask=mask)
    rd, ri = ref.index.search(q, K, nprobe=8, rerank=0, mask=mask)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(d, rd)


def test_acorn_search_equals_reference_on_carried_graph(corpus, ref_built):
    x, q, mask = corpus
    b = _carried("acorn", corpus, ref_built)
    ref = ref_built["acorn"]
    for tier in b.knob_grid():
        for m in (mask, None):
            d, i = b.search_masked(q, m, K, knobs=tier.knobs)
            rd, ri = ref.search_masked(q, m, K, knobs=tier.knobs)
            np.testing.assert_array_equal(i, ri)
            np.testing.assert_array_equal(d, rd)


@pytest.mark.parametrize("carried", [False, True])
def test_acorn_search_torch_recall(built, corpus, ref_built, carried):
    """The device beam search keeps the fast tier's floor against the
    exact oracle, on the port's own graph and on the reference's."""
    x, q, mask = corpus
    b = _carried("acorn", corpus, ref_built) if carried else built["acorn"]
    floor = b.knob_grid()[0].recall_floor
    for m in (mask, None):
        _, truth = _exact_masked(x, q, m, K)
        d, i = b.index.search_torch(q, K, ef=64, mask=m)
        i = i.numpy()
        assert _recall(i, truth) >= floor
        if m is not None:
            assert m[i[i >= 0]].all()
    if carried:
        # the reference's fixed-shape search on the same graph
        rd, ri = ref_built["acorn"].index.search_jax(q, K, ef=64, mask=mask)
        d, i = b.index.search_torch(q, K, ef=64, mask=mask)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# a routed engine under the reference's planner and routing head
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def routed():
    ds = make_dataset("arxiv", "4000", seed=0)
    n = 40
    _, preds, sels = gen_queries(ds.vectors, ds.cat, ds.num, n, kinds=ds.filter_kinds, seed=1)
    _, rpreds, _ = ref_trainer.gen_queries(ds.vectors, ds.cat, ds.num, n,
                                           kinds=ds.filter_kinds, seed=1)
    ref = RefEngine(ds.vectors, ds.cat, ds.num,
                    RefConfig(seed=0, backends=DEFAULT_BACKENDS)).build()
    ref.estimator.fit(rpreds[:20], sels[:20])
    ref.planner.load_state(_threshold_head(0.0301))
    # a routing head over the 8 classes, trained on selectivity bins of the
    # rows the plan head sends to post (the others are left unlabelled, -1)
    feats = np.stack([ref.feat.vector(p, se.sel, K, se.is_exact)
                      for p, se in ((p, ref.estimator.estimate(p)) for p in rpreds)])
    names = ref.backend_set.class_names()
    post = np.flatnonzero(np.asarray(sels) > 0.0301)
    labels = np.full(n, -1, np.int64)
    labels[post[np.argsort(np.asarray(sels)[post], kind="stable")]] = (
        np.arange(post.size) * len(names) // post.size)
    ref.planner.fit_routing(feats, labels, names)
    ref.plan_cache.clear()
    port = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                             EngineConfig(seed=0, device=DEV, backends=DEFAULT_BACKENDS)).build()
    rb = ref.backend_set.backends
    carry.install(port, centroids=ref.ivf.centroids, assignment=carry.ivf_assignment(ref.ivf),
                  gbm=carry.gbm_state(ref.estimator.model), planner=ref.planner.state_dict(),
                  backend_ivf=(rb["ivf"].index.centroids, carry.ivf_assignment(rb["ivf"].index)),
                  ivfpq=carry.ivfpq_state(rb["ivfpq"].index),
                  acorn=carry.acorn_state(rb["acorn"].index))
    ors = [(Or((preds[i], preds[i + 1])), RefOr((rpreds[i], rpreds[i + 1])))
           for i in range(20, n - 1, 4)]
    return ds, port, ref, list(preds[20:]) + [o for o, _ in ors], \
        list(rpreds[20:]) + [r for _, r in ors]


def test_routed_engine_plans_and_answers_equal_reference(routed):
    """Same classes, same per-clause (decision, route, backend, knob) from
    make_plan and make_plan_batch; routed rows answer alike, up to ties."""
    ds, port, ref, preds, rpreds = routed
    assert port._routing_active() and ref._routing_active()
    assert port.backend_set.class_names() == ref.backend_set.class_names()

    def sig(plan):
        return [(c.decision, c.route, c.backend, c.knob) for c in plan.clauses]

    plans = [port.make_plan(p, K)[0] for p in preds]
    rplans = [ref.make_plan(p, K)[0] for p in rpreds]
    assert [sig(p) for p in plans] == [sig(p) for p in rplans]
    assert [sig(p) for p in port.make_plan_batch(preds, K)[0]] == [sig(p) for p in plans]
    routes = {c.backend for p in plans for c in p.clauses if c.route >= 0}
    assert len(routes) >= 2, routes
    rng = np.random.default_rng(4)
    a, b = rng.integers(ds.vectors.shape[0], size=(2, len(preds)))
    qs = ((ds.vectors[a] + ds.vectors[b]) / 2).astype(np.float32)
    batch = port.batch_query(qs, preds, K)
    for i in range(len(preds)):
        r = port.query(qs[i], preds[i], K)
        rr = ref.query(qs[i], rpreds[i], K)
        assert (r.result.backend, r.result.knob) == (rr.result.backend, rr.result.knob)
        _same_up_to_ties(qs[i], r.result.ids, r.result.dists, rr.result.ids, rr.result.dists)
        np.testing.assert_array_equal(batch[i].result.ids, r.result.ids)
        mask = preds[i].eval(ds.cat, ds.num)
        ids = r.result.ids[r.result.ids >= 0]
        assert mask[ids].all() and len(set(ids.tolist())) == len(ids)


def test_routed_label_and_fit(routed):
    """``label_query`` races all 8 classes; ``fit`` trains the routing head
    over the engine's classes, so routing is active afterwards."""
    ds, _, _, preds, _ = routed
    e = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                          EngineConfig(seed=0, device=DEV, backends=("flat", "ivf"))).build()
    assert e.backend_set.class_names() == ("flat:exact", "ivf:fast", "ivf:balanced",
                                           "ivf:precise")
    lab = e.label_query(ds.vectors[0], preds[0], K)
    assert lab.route_utils.shape == (4,) and 0 <= lab.route < 4
    qs = ds.vectors[:8] + 0.01
    e.fit(qs, preds[:8], K)
    assert e._routing_active() and e.route_labels_.shape == (8,)
    r = e.query(qs[0], preds[0], K)
    assert r.result.ids.shape == (1, K)

"""The port's serving engine and RAG server against the JAX package's.

``tests/test_serve.py`` ported to ``repro_torch.serve`` at the fp32
``qwen3-14b.reduced()`` config, with the reference's weights carried in
(``carry.model_params_from_reference``).  Generated ids are held to the
reference's own ``ServeEngine.run`` tokens, not only to the port's
invariants.  The RAG server runs over the 4000-row arxiv engines of
``test_torch_engine.py`` (the ANN state carried by ``carry.install``) with
the reference's projection: estimates, decisions and ids (up to exact
distance ties) equal the reference's, and every id passes its predicate.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import Predicate as RefPredicate
from repro.core import RangePred as RefRangePred
from repro.models import Model as RefModel
from repro.serve import Request as RefRequest
from repro.serve import RetrievalAugmentedServer as RefRAG
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import carry
from repro_torch.configs import get_config
from repro_torch.core import Predicate, RangePred
from repro_torch.kernels import ops
from repro_torch.serve import Request, RetrievalAugmentedServer, ServeEngine
from test_torch_engine import _same_up_to_ties, engines  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def small_model():
    cfg = dataclasses.replace(get_config("qwen3-14b").reduced(), dtype="float32")
    ref_cfg = dataclasses.replace(ref_get_config("qwen3-14b").reduced(), dtype="float32")
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    model = carry.model_params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                              device="cpu")
    return cfg, model, ref, params


def _prompts(cfg, seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]


def _serve_both(small_model, prompts, new, slots, max_len=32):
    cfg, model, ref, params = small_model
    port = ServeEngine(model, batch_slots=slots, max_len=max_len).run(
        [Request(uid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(zip(prompts, new))])
    refo = RefServeEngine(ref, params, batch_slots=slots, max_len=max_len).run(
        [RefRequest(uid=i, prompt=p, max_new_tokens=n)
         for i, (p, n) in enumerate(zip(prompts, new))])
    return port, refo


def test_serve_engine_generates_reference_tokens(small_model):
    cfg = small_model[0]
    prompts = _prompts(cfg, 0, [8] * 5)
    port, refo = _serve_both(small_model, prompts, [5] * 5, slots=2)
    assert set(port) == {0, 1, 2, 3, 4}
    assert all(len(v) == 5 and all(0 <= t < cfg.vocab_size for t in v) for v in port.values())
    assert port == refo


def test_ragged_batch_equals_solo_and_reference(small_model):
    """A padded prefill batch gathers each row at its true last position:
    unequal prompts decode as their solo runs, and as the reference's."""
    cfg, model = small_model[:2]
    prompts = _prompts(cfg, 3, (3, 8, 5))
    port, refo = _serve_both(small_model, prompts, [4, 6, 3], slots=3)
    assert port == refo
    for i, p in enumerate(prompts):
        solo = ServeEngine(model, batch_slots=1, max_len=32).run(
            [Request(uid=0, prompt=p, max_new_tokens=len(port[i]))])[0]
        assert port[i] == solo, f"generation forked for prompt {i}"


def test_serve_greedy_deterministic(small_model):
    cfg, model = small_model[:2]
    prompt = np.arange(8, dtype=np.int32) % cfg.vocab_size
    outs = [ServeEngine(model, batch_slots=1, max_len=32).run(
        [Request(uid=0, prompt=prompt, max_new_tokens=6)])[0] for _ in range(2)]
    assert outs[0] == outs[1]


def test_serve_matches_teacher_forced(small_model):
    """Greedy generation equals repeated argmax over teacher-forced logits,
    and the decode steps went through the decode attention wrapper."""
    cfg, model = small_model[:2]
    prompt = _prompts(cfg, 1, [8])[0]
    ops.reset_dispatch_stats()
    gen = ServeEngine(model, batch_slots=1, max_len=32).run(
        [Request(uid=0, prompt=prompt, max_new_tokens=4)])[0]
    assert ops.dispatch_counts()["decode_attention"] == 3 * cfg.n_layers
    toks = list(prompt)
    for expected in gen:
        logits, _ = model.forward({"tokens": np.asarray(toks, np.int32)[None]})
        nxt = int(torch.argmax(logits[0, -1]))
        assert nxt == expected
        toks.append(nxt)


def test_serve_refuses_what_the_cache_cannot_hold(small_model):
    cfg, model = small_model[:2]
    with pytest.raises(ValueError, match="max_len"):
        ServeEngine(model, batch_slots=1, max_len=10).run(
            [Request(uid=0, prompt=_prompts(cfg, 4, [8])[0], max_new_tokens=4)])


class _ForcedEosModel:
    """Stub model: first token is 2, every decode step then emits EOS=3."""

    vocab, eos = 8, 3
    device = torch.device("cpu")

    def prefill(self, batch, max_len, lengths=None):
        b = batch["tokens"].shape[0]
        logits = torch.zeros((b, self.vocab))
        logits[:, 2] = 5.0
        return logits, {"step": torch.zeros((b,), dtype=torch.int32)}

    def decode_step(self, cache, tokens, lengths):
        logits = torch.zeros((tokens.shape[0], self.vocab))
        logits[:, self.eos] = 5.0
        return logits, cache


def test_serve_stops_decoding_after_all_eos():
    """Once every slot is done the engine stops stepping instead of idling
    through max_new - 1 iterations."""
    stub = _ForcedEosModel()
    eng = ServeEngine(stub, batch_slots=2, max_len=16, eos_id=stub.eos)
    calls = {"n": 0}
    orig = eng._decode

    def counting(*args):
        calls["n"] += 1
        return orig(*args)

    eng._decode = counting
    out = eng.run([
        Request(uid=0, prompt=np.array([1, 2], np.int32), max_new_tokens=12),
        Request(uid=1, prompt=np.array([1], np.int32), max_new_tokens=12),
    ])
    assert out[0] == [2, stub.eos] and out[1] == [2, stub.eos]
    assert calls["n"] == 1, f"decode dispatched {calls['n']} times after EOS"


def test_serve_rejects_unequal_lengths_for_recurrent_models():
    stub = _ForcedEosModel()
    stub.supports_ragged_prefill = False
    eng = ServeEngine(stub, batch_slots=2, max_len=16, eos_id=stub.eos)
    with pytest.raises(ValueError, match="equal-length"):
        eng.run([
            Request(uid=0, prompt=np.array([1, 2, 3], np.int32), max_new_tokens=4),
            Request(uid=1, prompt=np.array([1], np.int32), max_new_tokens=4),
        ])
    out = eng.run([
        Request(uid=0, prompt=np.array([1, 2], np.int32), max_new_tokens=4),
        Request(uid=1, prompt=np.array([3, 4], np.int32), max_new_tokens=4),
    ])
    assert out[0] == [2, stub.eos] and out[1] == [2, stub.eos]


def test_rag_retrieval_equals_reference(small_model, engines):
    cfg, model, ref, params = small_model
    ds, port_ann, ref_ann, _, preds, rpreds = engines
    ref_rag = RefRAG(ref, params, ref_ann)
    rag = carry.retrieval_server(model, port_ann, np.asarray(ref_rag.proj))
    lo = float(np.quantile(ds.num[:, 0], 0.4))
    hi = float(np.quantile(ds.num[:, 0], 0.8))
    pairs = [(Predicate(ranges=(RangePred(0, ((lo, hi),)),)),
              RefPredicate(ranges=(RefRangePred(0, ((lo, hi),)),)))]
    pairs += list(zip(preds[:6], rpreds[:6]))
    tokens = _prompts(cfg, 5, [8, 8, 8])
    tokens = np.stack(tokens)
    np.testing.assert_allclose(rag.embed(tokens), np.asarray(ref_rag._embed(params, tokens)),
                               rtol=1e-4, atol=1e-5)
    strategies = set()
    for pred, rpred in pairs:
        outs, routs = rag.retrieve(tokens, pred, k=5), ref_rag.retrieve(tokens, rpred, k=5)
        assert len(outs) == len(routs) == 3
        for out, rout in zip(outs, routs):
            assert out.est_selectivity == rout.est_selectivity
            assert out.decision == rout.decision
            strategies.add(out.plan.strategy)
            _same_up_to_ties(out.result.ids, out.result.dists,
                             rout.result.ids, rout.result.dists)
            ids = out.result.ids[0]
            ids = ids[ids >= 0]
            assert ids.size > 0
            assert pred.eval(ds.cat[ids], ds.num[ids]).all()
    assert strategies == {"ipre", "post"}
    assert rag.last_timing["embed_s"] > 0 and rag.last_timing["ann_s"] > 0


def test_rag_refuses_split_devices_and_missing_projection(small_model, engines):
    model = small_model[1]
    port_ann = engines[1]

    class _Elsewhere:
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="one device"):
        RetrievalAugmentedServer(model, _Elsewhere())
    with pytest.raises(ValueError, match="Generator"):
        RetrievalAugmentedServer(model, port_ann)
    rag = RetrievalAugmentedServer(model, port_ann, generator=torch.Generator().manual_seed(0))
    assert rag.proj.shape == (model.cfg.d_model, port_ann.vectors.shape[1])

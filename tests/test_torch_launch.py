"""The port's serve CLI (``repro_torch.launch.serve``) against the JAX package's.

Both CLIs run in-process on the same flags at a small size (a 2,000-row
arxiv corpus, 16 fit queries, a pool of 8 predicates, 40 requests), the
port on ``--device cpu``.  The ann-trace snapshot has the reference's keys
(its data-dependent ones, such as which backends or batch sizes occurred,
aside); ``--explain`` prints one plan tree per sample; ``--mode lm`` serves
every request its ``--new-tokens`` for each architecture the port added.
"""
import contextlib
import io

import pytest

from repro.launch.serve import main as ref_main
from repro_torch.launch import serve

FLAGS = ["--mode", "ann-trace", "--corpus", "2000", "--fit-queries", "16", "--pool", "8",
         "--requests", "40"]
# sub-dicts whose keys do not depend on the trace's data
FIXED = ("plan_counts", "deadline_met", "latency_virtual", "latency_by_tier",
         "queue_wait_virtual", "wall", "engine")


def _quiet(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(argv)
    return result, out.getvalue()


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    trace_out = tmp_path_factory.mktemp("cli") / "spans.jsonl"
    port, text = _quiet(serve.main, FLAGS + ["--device", "cpu", "--shards", "2",
                                             "--probe-rate", "0.2",
                                             "--trace-out", str(trace_out)])
    ref, _ = _quiet(ref_main, FLAGS + ["--shards", "2", "--probe-rate", "0.2"])
    return port, ref, text, trace_out


def test_ann_trace_snapshot_has_reference_keys(snapshots):
    port, ref, _, _ = snapshots
    assert sorted(port) == sorted(ref)
    for key in FIXED:
        assert sorted(port[key]) == sorted(ref[key]), key
    assert port["n_completed"] == ref["n_completed"] == 40
    assert "probe" in port and "span_summary" in port


def test_ann_trace_prints_its_report_and_writes_spans(snapshots):
    port, _, text, trace_out = snapshots
    assert "corpus: arxiv n=2000 d=384" in text
    assert "trace: poisson" in text and "shards=2" in text
    lines = trace_out.read_text().splitlines()
    assert lines and f"wrote {len(lines)} spans" in text


def test_explain_prints_one_tree_per_sample():
    result, text = _quiet(serve.main, FLAGS + ["--device", "cpu", "--explain"])
    assert result == {}
    # three pool predicates and one Or of the first two
    assert text.count("ExecutionPlan") == 4
    assert "merge=union" in text


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b", "llama4-scout-17b-a16e",
                                  "qwen3-14b", "hymba-1.5b", "xlstm-1.3b"])
def test_lm_mode_serves_every_request(arch):
    results, text = _quiet(serve.main, ["--mode", "lm", "--device", "cpu", "--arch", arch,
                                        "--requests", "5", "--new-tokens", "6",
                                        "--prompt-len", "20", "--slots", "2"])
    assert sorted(results) == list(range(5))
    assert all(len(t) == 6 for t in results.values())
    assert "served 5 requests, 30 tokens" in text


def test_device_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _quiet(serve.main, ["--mode", "lm", "--arch", "gemma2-2b", "--requests", "1"])

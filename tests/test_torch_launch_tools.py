"""The port's launch tools against the JAX package's, on the CPU.

* configs: qwen3-32b, deepseek-67b and ``paper_ann`` equal the reference's
  field by field, and the two dense configs' reduced models give the
  reference's logits (fp32, weights carried, rtol = atol = 1e-4);
* ``analytic_cost``: every field equal bit for bit, for every architecture
  of the port's registry x every ``SHAPES`` entry x the meshes (16, 16),
  (32, 8), (2*16, 16) and (1, 1), with and without the int8 KV cache;
* ``analyse``: with the port's ``HW`` set to the reference's constants,
  equal terms and bottleneck; under its own (H100) ``HW`` the terms scale
  by the ratio of the constants;
* ``Model.input_specs``: the reference's keys, shapes and dtypes;
* ``report``: the reference's tables line for line on the same records,
  apart from the fits column (and the dry-run table's traced and
  collective columns, which have no HLO source here).

The dry-run itself is held in ``tests/test_torch_dryrun.py``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import paper_ann as ref_paper_ann
from repro.launch import report as ref_report
from repro.launch import roofline as ref_roofline
from repro.launch.analytics import analytic_cost as ref_analytic_cost
from repro.models import Model as RefModel
from repro_torch import carry
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, get_config, paper_ann
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.analytics import analytic_cost
from repro_torch.models import Model

MESHES = [(16, 16), (32, 8), (2 * 16, 16), (1, 1)]


def _cfgs(arch, **overrides):
    return (dataclasses.replace(ref_get_config(arch), **overrides),
            dataclasses.replace(get_config(arch), **overrides))


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-67b"])
def test_config_copies_match_reference(arch):
    ref, port = _cfgs(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.n_params() == ref.n_params()


def test_paper_ann_matches_reference():
    assert {k: dataclasses.asdict(v) for k, v in paper_ann.ANN_CONFIGS.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_paper_ann.ANN_CONFIGS.items()}


@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-67b"])
def test_reduced_dense_logits_match_reference(arch):
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = carry.model_params_from_reference(cfg, jax.tree.map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    r, _ = ref.forward(params, {"tokens": jnp.asarray(toks)})
    p, _ = port.forward({"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# analytic cost model and roofline terms
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_cost_bit_for_bit(arch, shape, mesh, kv_int8):
    ref_cfg, cfg = _cfgs(arch, kv_cache_int8=kv_int8)
    got = analytic_cost(cfg, SHAPES[shape], *mesh).to_dict()
    want = ref_analytic_cost(ref_cfg, REF_SHAPES[shape], *mesh).to_dict()
    assert got == want


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen3-32b", "decode_32k", (1, 1)), ("gemma2-2b", "train_4k", (16, 16)),
    ("olmoe-1b-7b", "prefill_32k", (32, 8)), ("xlstm-1.3b", "long_500k", (2 * 16, 16))])
def test_analyse_equals_reference_under_its_constants(arch, shape, mesh, monkeypatch):
    ref_cfg, cfg = _cfgs(arch)
    chips = math.prod(mesh)
    mf = dryrun._model_flops(cfg, SHAPES[shape])
    ref = ref_roofline.analyse({}, "", chips, model_flops=mf,
                               analytic=ref_analytic_cost(ref_cfg, REF_SHAPES[shape], *mesh))
    ac = analytic_cost(cfg, SHAPES[shape], *mesh)
    own = roofline.analyse({}, chips, model_flops=mf, analytic=ac)
    hw, ref_hw = roofline.HW, ref_roofline.HW
    assert own.compute_s == pytest.approx(ref.compute_s * ref_hw["peak_flops"] / hw["peak_flops"])
    assert own.memory_s == pytest.approx(ref.memory_s * ref_hw["hbm_bw"] / hw["hbm_bw"])
    assert own.collective_s == pytest.approx(
        ref.collective_s * ref_hw["link_bw"] * 4 / (hw["link_bw"] * roofline.NVLINK_LINKS))
    monkeypatch.setattr(roofline, "HW", dict(ref_hw))
    same = roofline.analyse({}, chips, model_flops=mf, links=4, analytic=ac)
    for f in ("flops", "hbm_bytes", "coll_bytes", "chips", "compute_s", "memory_s",
              "collective_s", "bottleneck", "model_flops", "useful_ratio"):
        assert getattr(same, f) == getattr(ref, f), f


def test_analyse_identifies_bottleneck():
    """The reference's test, at the H100's constants."""
    class A:
        flops = 1e18          # global
        hbm_bytes = 1e12
        coll_bytes_per_dev = 1e6

    t = roofline.analyse({"flops": 1.0, "bytes accessed": 1.0}, chips=256,
                         model_flops=5e17, analytic=A)
    assert t.bottleneck == "compute"
    assert abs(t.compute_s - 1e18 / (256 * roofline.HW["peak_flops"])) < 1e-12
    assert 0.49 < t.useful_ratio < 0.51
    assert t.coll_detail["traced_flops_per_dev"] == 1.0


def test_qwen3_32b_one_card_decode_figures():
    """The analytic model's one-card decode at B=8, S=2088: 135.48 GB (the
    weights counted twice, as the reference's FSDP model does), 40.44 ms
    at 3.35 TB/s."""
    ac = analytic_cost(get_config("qwen3-32b"), ShapeSpec("decode_2088", 2088, 8, "decode"), 1, 1)
    t = roofline.analyse({}, 1, analytic=ac)
    assert round(ac.hbm_bytes / 1e9, 2) == 135.48
    assert round(t.memory_s * 1e3, 2) == 40.44


# ----------------------------------------------------------------------
# input specs
# ----------------------------------------------------------------------
def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    dt = tree.dtype
    name = str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) else jnp.dtype(dt).name
    return (tuple(tree.shape), name)


@pytest.mark.parametrize("arch,kv_int8", [
    (a, False) for a in ("qwen3-14b", "gemma2-2b", "olmoe-1b-7b", "hymba-1.5b", "xlstm-1.3b",
                         "seamless-m4t-large-v2", "internvl2-76b")]
    + [("qwen3-14b", True), ("hymba-1.5b", True)])
def test_input_specs_equal_reference(arch, kv_int8):
    ref_cfg, cfg = _cfgs(arch, kv_cache_int8=kv_int8)
    ref, port = RefModel(ref_cfg.reduced()), Model(cfg.reduced(), device="cpu")
    for name, shape in SHAPES.items():
        specs = port.input_specs(shape)
        assert _spec_tree(specs) == _spec_tree(ref.input_specs(REF_SHAPES[name])), name
        assert all(isinstance(t, torch._subclasses.fake_tensor.FakeTensor)
                   for t in jax.tree.leaves(specs))


# ----------------------------------------------------------------------
# report
# ----------------------------------------------------------------------
def _record(arch, shape, mesh="16x16", temp=3 * 2**30, args=70 * 2**30, status="ok"):
    if status != "ok":
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": status,
                "reason": "pure full-attention arch: long_500k needs sub-quadratic attention"}
    ac = analytic_cost(get_config(arch), SHAPES[shape], 16, 16)
    t = roofline.analyse({}, 256, model_flops=1e15, analytic=ac).to_dict()
    t["coll_detail"].update(count=12, parsed_coll_bytes_once=3 * 2**20)
    return {"arch": arch, "shape": shape, "mesh": mesh, "chips": 256, "status": "ok",
            "compile_s": 1.5, "cost_flops": 1.2e13, "cost_bytes": 3.4e11, "roofline": t,
            "memory_analysis": {"argument_bytes": args, "output_bytes": 0, "temp_bytes": temp,
                                "generated_code_bytes": 0}}


def _cols(line, keep):
    cells = line.split("|")[1:-1]
    return [c for i, c in enumerate(cells) if i in keep]


def test_report_tables_equal_reference():
    rows = [_record("gemma2-2b", "train_4k"), _record("qwen3-32b", "decode_32k", temp=14 * 2**30),
            _record("olmoe-1b-7b", "prefill_32k", mesh="2x16x16"),
            _record("qwen3-32b", "long_500k", status="skipped"),
            {"arch": "deepseek-67b", "shape": "train_4k", "mesh": "16x16", "status": "error"}]
    ours, theirs = report.roofline_table(rows).splitlines(), ref_report.roofline_table(
        rows).splitlines()
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert _cols(a, range(9)) == _cols(b, range(9))
    assert "fits 80G" in ours[0] and "fits 16G" in theirs[0]
    # 70 + 14 GiB does not fit 80G; 70 + 3 does
    assert ours[3].endswith("| NO |") and ours[2].endswith("| yes |")
    ours, theirs = report.dryrun_table(rows).splitlines(), ref_report.dryrun_table(
        rows).splitlines()
    assert len(ours) == len(theirs)
    for a, b in zip(ours[2:], theirs[2:]):
        assert _cols(a, [0, 1, 2, 3, 4, 5, 7, 8]) == _cols(b, [0, 1, 2, 3, 4, 5, 7, 8])
    base = [dict(r, memory_analysis=dict(r["memory_analysis"], temp_bytes=2**30))
            if r.get("status") == "ok" else r for r in rows]
    assert report.before_after(base, rows) == ref_report.before_after(base, rows)

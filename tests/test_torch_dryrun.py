"""The port's dry-run against the JAX package's arithmetic, on the CPU.

* on a fake (4, 2) mesh, for the reduced gemma2 and olmoe (train,
  prefill, decode): every key of the reference's record, the trace one
  rank of the model axis (its blocks of the cut weights),
  ``argument_bytes`` equal to the local shard bytes of the reference's own
  spec arithmetic at the port's stored types, the analytic roofline equal
  to the reference's ``analytic_cost``, train FLOPs within the
  reference's 7-12 x N·D band (``tests/test_roofline.py``; N the
  parameters the rank's compute reads), decode GEMM FLOPs within 2 % of
  the rank's share of the analytic projection and head (MoE: every expert
  of the rank over its slots, the port's dense dispatch);
* a (1, 1) record's traced fields equal the trace of the whole model, and
  a (1, 2) train cell (weights and their grads dominating its temp) counts
  at most 0.6 of the (1, 1) cell's FLOPs and temp bytes;
* reduced seamless-m4t (encdec) and internvl2 (vlm) prefill and decode
  cells on a 1 x 1 mesh record ``status: ok`` with the reference's
  argument bytes (the vlm prefill's cache holds the prefix), an unknown
  family raises and leaves no process group behind, and the extrapolation
  from depths 1 and 2 (an encdec model's two stacks together) gives the
  FLOPs of a full trace at depth 4 within 1 %;
* the CLI for qwen3-32b decode_32k on the 16 x 16 mesh writes a record
  with every key of the reference's, and the report CLI renders it.
"""
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from repro.configs import ShapeSpec as REF_SHAPE_SPEC
from repro.configs import get_config as ref_get_config
from repro.dist import sharding as ref_sharding
from repro.launch import roofline as ref_roofline
from repro.launch.analytics import analytic_cost as ref_analytic_cost
from repro.models import Model as RefModel
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.dist.sharding import reference_path
from repro_torch.dist.tensor_parallel import ModelAxis
from repro_torch.launch import dryrun, report
from repro_torch.launch.analytics import analytic_cost
from repro_torch.models import Model

SRC = Path(__file__).resolve().parents[1] / "src"


REF_RECORD_KEYS = {"arch", "shape", "mesh", "chips", "status", "lower_s", "compile_s",
                   "memory_analysis", "cost_flops", "cost_bytes", "roofline", "n_params",
                   "n_active_params", "model_flops"}
REF_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "generated_code_bytes"}
ROOFLINE_KEYS = {f.name for f in dataclasses.fields(ref_roofline.RooflineTerms)}


def _expected_argument_bytes(ref_cfg, cfg, shape, mesh):
    """One device's argument bytes by the reference's own spec arithmetic
    (its ``param_sharding``, ``batch_sharding`` and ``cache_sharding`` on
    an abstract mesh, ``shard_shape``), at the port's stored types: bf16
    weights (fp32 where the port keeps them so) in serving, fp32 masters,
    m and v and an int32 step in training."""
    amesh = jax.sharding.AbstractMesh(mesh, ("data", "model"))
    ref = RefModel(ref_cfg)
    params = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0)))
    elem = {reference_path(name)[0]: 4 if shape.kind == "train" else t.element_size()
            for name, t in Model(cfg, device="cpu").named_parameters()}
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    shards = jax.tree.leaves(ref_sharding.param_sharding(amesh, params))
    total = sum(math.prod(s.shard_shape(leaf.shape)) * elem[ref_sharding._path_str(path)]
                for (path, leaf), s in zip(flat, shards))
    if shape.kind == "train":
        total = 3 * total + 4
    specs = ref.input_specs(REF_SHAPE_SPEC(shape.name, shape.seq_len, shape.global_batch,
                                           shape.kind))
    b = shape.global_batch
    if shape.kind == "decode":
        trees = [(specs["cache"], ref_sharding.cache_sharding(amesh, specs["cache"], b)),
                 *[(specs[k], ref_sharding.batch_sharding(amesh, specs[k], b))
                   for k in ("tokens", "lengths")]]
    else:
        trees = [(specs["batch"], ref_sharding.batch_sharding(amesh, specs["batch"], b))]
    for tree, sh in trees:
        total += sum(math.prod(s.shard_shape(t.shape)) * jnp.dtype(t.dtype).itemsize
                     for t, s in zip(jax.tree.leaves(tree), jax.tree.leaves(sh)))
    return total


DRY_SHAPES = [ShapeSpec("train_64", 64, 8, "train"), ShapeSpec("prefill_64", 64, 8, "prefill"),
              ShapeSpec("decode_96", 96, 8, "decode")]


@pytest.fixture(scope="module")
def dry_records():
    out = {}
    for arch in ("gemma2-2b", "olmoe-1b-7b"):
        for shape in DRY_SHAPES:
            out[arch, shape.kind] = dryrun.cell_record(get_config(arch).reduced(), shape,
                                                       mesh_shape=(4, 2), arch=arch)
    return out


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b"])
def test_dryrun_record_keys_and_argument_bytes(dry_records, arch, kind):
    rec = dry_records[arch, kind]
    assert rec["status"] == "ok" and rec["traced"] and rec["mesh"] == "4x2" and rec["chips"] == 8
    assert REF_RECORD_KEYS <= set(rec)
    assert set(rec["memory_analysis"]) == REF_MEMORY_KEYS
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert rec["trace_batch"] == 2 and "rank 0 of the model axis (2) traced" in rec["temp_scope"]
    assert rec["cost_flops"] > 0 and rec["cost_bytes"] > 0 and rec["memory_analysis"][
        "temp_bytes"] > 0
    shape = next(s for s in DRY_SHAPES if s.kind == kind)
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    assert rec["memory_analysis"]["argument_bytes"] == _expected_argument_bytes(
        ref_cfg, cfg, shape, (4, 2))
    ac = ref_analytic_cost(ref_cfg, REF_SHAPE_SPEC(shape.name, shape.seq_len,
                                                   shape.global_batch, kind), 8 // 2, 2)
    assert rec["roofline"]["flops"] == ac.flops and rec["roofline"]["coll_bytes"] == \
        ac.coll_bytes_per_dev


def _rank_params(cfg, n_model: int) -> int:
    """The parameters one rank's compute reads on a model axis of
    ``n_model``: a split unit's cut weights as its block, every other
    weight whole (a gathered weight is read whole)."""
    axis = ModelAxis(cfg, None, n_model, 0)
    return sum(t.numel() // (n_model if axis.use(name, t.shape)[0] == "split" else 1)
               for name, t in Model(cfg, device="cpu").named_parameters())


def test_dryrun_train_flops_in_the_reference_band(dry_records):
    """Dense train FLOPs ~ 8 N D (6ND + the recomputed forward) + attention:
    inside the reference's 7-12 x N·D band (tests/test_roofline.py), D the
    traced device's tokens and N the parameters its compute reads (rank 0
    of the model axis of 2)."""
    cfg = get_config("gemma2-2b").reduced()
    rec = dry_records["gemma2-2b", "train"]
    nd = _rank_params(cfg, 2) * rec["trace_batch"] * DRY_SHAPES[0].seq_len
    assert _rank_params(cfg, 2) < 0.6 * cfg.n_params()
    assert 7.0 * nd < rec["cost_flops"] < 12.0 * nd


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b"])
def test_dryrun_decode_gemm_flops(dry_records, arch):
    """Traced decode FLOPs less the plain attention's two einsums over the
    cache (4 b h dh S a layer, over the rank's heads) equal rank 0's share
    of the analytic projection and head flops within 2 %: at (4, 2) both
    configs split attention, the MLP or the experts and the vocab over the
    model axis of 2, so the rank runs half of those GEMMs; the MoE router
    runs whole on every rank.  The port's MoE runs every expert over its C
    slots at decode (the reference's dense dispatch), so there the
    experts' GEMMs count E x C, not top_k, SwiGLUs a row."""
    cfg = get_config(arch).reduced()
    n = 2
    rec, shape = dry_records[arch, "decode"], DRY_SHAPES[2]
    b, s, d = rec["trace_batch"], shape.seq_len, cfg.d_model
    attn = cfg.n_layers * 4 * b * cfg.n_heads * cfg.dh * s / n
    proj = analytic_cost(cfg, shape, 4, 2).detail["proj_flops_per_token_per_layer"]
    router = 2 * d * cfg.n_experts if cfg.is_moe else 0
    if cfg.is_moe:
        cap = int(max(1, cfg.capacity_factor * 1 * cfg.top_k_experts / cfg.n_experts))
        proj += 6 * d * cfg.d_ff * (cfg.n_experts * cap - cfg.top_k_experts)
    want = (cfg.n_layers * (proj - router) * b + 2 * d * cfg.vocab_size * b) / n \
        + cfg.n_layers * router * b
    assert abs(rec["cost_flops"] - attn - want) <= 0.02 * want


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_by_one_record_traces_the_whole_model(kind):
    """A (1, 1) mesh applies no model axis: its traced fields are the
    trace of the whole model, as they were before the trace cut a rank."""
    cfg = get_config("gemma2-2b").reduced()
    shape = next(s for s in DRY_SHAPES if s.kind == kind)
    rec = dryrun.cell_record(cfg, shape, mesh_shape=(1, 1), arch="gemma2-2b")
    whole = dryrun._traced(cfg, shape)
    assert "with every weight whole" in rec["temp_scope"]
    assert rec["cost_flops"] == whole["flops"] and rec["cost_bytes"] == whole["bytes"]
    assert rec["memory_analysis"]["temp_bytes"] == int(whole["temp"])


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b"])
def test_one_rank_of_two_traces_at_most_six_tenths(arch):
    """At (1, 2) the traced rank holds half of every split unit's weights,
    so at a batch small enough that the weights and their grads make up
    the step's temp (2 x 16 tokens), its train FLOPs and temp bytes are at
    most 0.6 of the (1, 1) cell's (observed 0.500 and 0.501)."""
    cfg, shape = get_config(arch).reduced(), ShapeSpec("train_16", 16, 2, "train")
    half, whole = (dryrun.cell_record(cfg, shape, mesh_shape=m, arch=arch)
                   for m in ((1, 2), (1, 1)))
    assert half["cost_flops"] <= 0.6 * whole["cost_flops"]
    assert half["memory_analysis"]["temp_bytes"] <= 0.6 * whole["memory_analysis"]["temp_bytes"]


FRONTEND_ARCHS = ["seamless-m4t-large-v2", "internvl2-76b"]


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_dryrun_frontend_family_cells_are_ok(tmp_path, arch):
    import torch.distributed as dist

    rec = dryrun.run_cell("gemma2-2b", "decode_32k", False, str(tmp_path), mesh_shape=(1, 1))
    assert rec["status"] == "ok"
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    for shape in DRY_SHAPES[1:]:
        rec = dryrun.cell_record(cfg, shape, mesh_shape=(1, 1), arch=arch)
        assert rec["status"] == "ok" and rec["traced"] and rec["cost_flops"] > 0, shape
        assert rec["memory_analysis"]["argument_bytes"] == _expected_argument_bytes(
            ref_cfg, cfg, shape, (1, 1)), shape
    bad = dataclasses.replace(cfg, family="audio")
    with pytest.raises(ValueError, match="unknown family"):
        dryrun.cell_record(bad, DRY_SHAPES[2], mesh_shape=(1, 1))
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_trace_depths_extrapolate_frontend_families(arch):
    """At depth 4 (an encdec model's encoder too) the traces at depths 1
    and 2, extrapolated, give a full trace's FLOPs within 1 %."""
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, n_layers=4, **({"n_enc_layers": 4} if cfg.is_encdec else {}))
    shape = DRY_SHAPES[1]
    assert dryrun._trace_depths(cfg, shape) == (1, 2)
    ext, full = dryrun._traced(cfg, shape), dryrun._trace_at(cfg, shape)
    assert ext["trace_depths"] == [1, 2]
    assert abs(ext["flops"] - full["flops"]) <= 0.01 * full["flops"]


def test_dryrun_and_report_cli(tmp_path):
    """The acceptance command on the CPU: qwen3-32b decode_32k on the 16 x
    16 mesh writes a record with every key of the reference's, and the
    report renders it."""
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "qwen3-32b", "--shape", "decode_32k", "--mesh", "single", "--out",
                          str(tmp_path)], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = report.load(str(tmp_path))
    assert len(rec) == 1 and REF_RECORD_KEYS <= set(rec[0]) and rec[0]["status"] == "ok"
    # every weight of the 16 x 16 mesh's plan (bf16) and 8 rows of the cache a device
    cfg = get_config("qwen3-32b")
    cache = 2 * cfg.n_layers * 8 * cfg.n_kv_heads * 32_768 * cfg.dh * 2
    assert rec[0]["memory_analysis"]["argument_bytes"] > cache
    shown = subprocess.run([sys.executable, "-m", "repro_torch.launch.report", "--dir",
                            str(tmp_path)], capture_output=True, text=True, env=env, timeout=120)
    assert shown.returncode == 0, shown.stderr
    assert "| qwen3-32b | decode_32k | " in shown.stdout and "fits 80G" in shown.stdout

"""The port's int8 all-reduces (``repro_torch.dist.compressed_psum``,
``psum_with_error_feedback``) against the JAX package's, on the CPU.

The quantisation is the reference's bit for bit.  The all-reduces run on a
``gloo`` group of 4 processes on this machine (``tcp://localhost``), each
rank holding one shard, and are held to the bounds of the reference's
``tests/test_dist.py`` and to the reference's per-shard arithmetic (its
``_quantize_int8`` on each shard, the dequantised shards summed in numpy).
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.collectives import _quantize_int8 as ref_quantize_int8
from repro_torch.dist import collectives

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
EF_ROUNDS = 8

# one rank: its shard of x and g from numpy with a seed, then the three calls
WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist import compressed_psum, psum_with_error_feedback

rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank)
try:
    x = np.random.default_rng(rank).normal(0, 1, 64).astype(np.float32)
    g = np.random.default_rng(100 + rank).normal(0, 1, 32).astype(np.float32)
    mean = compressed_psum(torch.from_numpy(x))
    err = torch.zeros(32)
    means, errs = [], []
    for _ in range(int(sys.argv[5])):
        m, new_err = psum_with_error_feedback(torch.from_numpy(g), err)
        assert tuple(new_err.shape) == (1, 32)
        means.append(m.tolist())
        errs.append(new_err[0].tolist())
        err = new_err[0]
    with open(out, "w") as f:
        json.dump({"mean": mean.tolist(), "ef_means": means, "ef_errs": errs}, f)
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results from one run of the 4-process gloo group."""
    d = tmp_path_factory.mktemp("gloo")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(WORLD), str(port),
                               str(d / f"rank{r}.json"), str(EF_ROUNDS)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(WORLD)]


def _shards(seed0, n):
    return np.stack([np.random.default_rng(seed0 + r).normal(0, 1, n).astype(np.float32)
                     for r in range(WORLD)])


def _ref_mean(shards):
    """The reference's per-shard arithmetic in numpy: each shard quantised
    by its ``_quantize_int8``, dequantised, summed, divided by n."""
    deq = []
    for s in shards:
        q, scale = ref_quantize_int8(jnp.asarray(s))
        deq.append(np.asarray(q).astype(np.float32) * np.float32(scale))
    return np.sum(deq, axis=0, dtype=np.float32) / np.float32(len(shards))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_int8_bitwise_equals_reference(scale):
    x = (np.random.default_rng(7).normal(0, 1, (5, 37)) * scale).astype(np.float32)
    x[0, :3] = [0.5 * scale, -0.5 * scale, 0.0]
    q, s = collectives._quantize_int8(torch.from_numpy(x))
    rq, rs = ref_quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(rq))
    assert np.float32(s) == np.float32(rs)
    q0, s0 = collectives._quantize_int8(torch.zeros(4))      # the 1e-12 floor
    assert float(s0) == float(np.asarray(ref_quantize_int8(jnp.zeros(4))[1])) and \
        not q0.any()


def test_compressed_psum_close_to_exact(ranks):
    x = _shards(0, 64)
    out = np.asarray(ranks[0]["mean"], np.float32)
    assert all(r["mean"] == ranks[0]["mean"] for r in ranks)      # every rank alike
    err = np.abs(out - x.mean(0)).max()
    assert err <= 2 * np.abs(x).max() / 127, err
    np.testing.assert_allclose(out, _ref_mean(x), rtol=0, atol=1e-6)


def test_error_feedback_reduces_bias(ranks):
    g = _shards(100, 32)
    means = np.asarray(ranks[0]["ef_means"], np.float32)
    assert all(r["ef_means"] == ranks[0]["ef_means"] for r in ranks)
    assert np.abs(means.mean(0) - g.mean(0)).max() < 0.02
    # round by round, the reference's arithmetic on each rank's carried residual
    err = np.zeros_like(g)
    for t in range(EF_ROUNDS):
        comp = g + err
        np.testing.assert_allclose(means[t], _ref_mean(comp), rtol=0, atol=1e-6)
        deq = []
        for c in comp:
            q, s = ref_quantize_int8(jnp.asarray(c))
            deq.append(np.asarray(q).astype(np.float32) * np.float32(s))
        err = comp - np.stack(deq)
        got = np.stack([r["ef_errs"][t] for r in ranks]).astype(np.float32)
        np.testing.assert_allclose(got, err, rtol=0, atol=1e-6)

"""The port's recurrences against the JAX package's, on the CPU.

``repro_torch.models.ssm`` (mLSTM chunkwise and cell, sLSTM, Mamba) takes
the reference's own parameters (``repro.models.ssm.*_init``, drawn with
``jax.random``, as numpy) and the same seeded numpy inputs and states, in
fp32.  Outputs and final states are compared at rtol = atol = 2e-4: the
reference's own band for its chunkwise form against its per-step cell
(``tests/test_ssm_chunkwise.py``), since the two packages sum the chunk's
products and the scan's terms in other orders.  The port's chunkwise
mLSTM is also held to its own cell within that band, as the reference's
is, and ``mamba_step`` continues ``mamba_seq``'s state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.models import ssm

TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(arch):
    ref = dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32")
    return ref, dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _params(init, ref_cfg, seed=0):
    p = init(jax.random.PRNGKey(seed), ref_cfg)
    return p, {k: torch.as_tensor(np.array(v)) for k, v in p.items()}


def _x(cfg, b, s, seed=1):
    return (np.random.default_rng(seed).normal(0, 1, (b, s, cfg.d_model)) * 0.5).astype(np.float32)


def _state(ref_state):
    """A reference state dict with random contents, for both packages."""
    rng = np.random.default_rng(7)
    out = {}
    for k, v in ref_state.items():
        a = rng.normal(0, 0.3, np.shape(v)).astype(np.float32)
        if k == "m":
            a = a - 1.0
        if k == "n" and np.ndim(v) == 3 and "c" in ref_state:
            a = np.abs(a) + 0.5          # sLSTM's normaliser stays positive
        out[k] = a
    return {k: jnp.asarray(v) for k, v in out.items()}, {k: torch.as_tensor(v) for k, v in out.items()}


def _close(port, ref, what=""):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _close(port[k], ref[k], f"{what}.{k}")
        return
    assert port.dtype == torch.float32, what
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL, err_msg=what)


@pytest.mark.parametrize("s", [1, 7, 256, 300])
def test_mlstm_seq_matches_reference(s):
    ref_cfg, cfg = _cfgs("xlstm-1.3b")
    rp, pp = _params(ref_ssm.mlstm_init, ref_cfg)
    x = _x(cfg, 2, s)
    ry, rst = ref_ssm.mlstm_seq(rp, jnp.asarray(x), ref_cfg)
    py, pst = ssm.mlstm_seq(pp, torch.as_tensor(x), cfg)
    _close(py, ry, "y")
    _close(pst, rst, "state")
    # the port's chunkwise form against its own cell, as the reference's
    st = ssm.mlstm_state(2, cfg)
    ys = []
    for t in range(s):
        y, st = ssm.mlstm_step(pp, torch.as_tensor(x[:, t]), cfg, st)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), py, **TOL)
    for k in ("C", "n", "m"):
        torch.testing.assert_close(st[k], pst[k], **TOL)


def test_mlstm_seq_from_a_state_and_step_match_reference():
    ref_cfg, cfg = _cfgs("xlstm-1.3b")
    rp, pp = _params(ref_ssm.mlstm_init, ref_cfg)
    rs, ps = _state(ref_ssm.mlstm_state(2, ref_cfg))
    x = _x(cfg, 2, 40, seed=2)
    ry, rst = ref_ssm.mlstm_seq(rp, jnp.asarray(x), ref_cfg, rs)
    py, pst = ssm.mlstm_seq(pp, torch.as_tensor(x), cfg, ps)
    _close(py, ry, "y")
    _close(pst, rst, "state")
    ry, rst = ref_ssm.mlstm_step(rp, jnp.asarray(x[:, 0]), ref_cfg, rs)
    py, pst = ssm.mlstm_step(pp, torch.as_tensor(x[:, 0]), cfg, ps)
    _close(py, ry, "step y")
    _close(pst, rst, "step state")


def test_mlstm_state_contract():
    _, cfg = _cfgs("xlstm-1.3b")
    st = ssm.mlstm_state(3, cfg)
    assert st["C"].shape == (3, cfg.n_heads, cfg.dh, cfg.dh)
    assert st["n"].shape == (3, cfg.n_heads, cfg.dh) and st["m"].shape == (3, cfg.n_heads)
    assert float(st["m"].max()) == float(np.float32(-1e30)) and not st["C"].any()


@pytest.mark.parametrize("s", [1, 9, 64])
def test_slstm_seq_and_step_match_reference(s):
    ref_cfg, cfg = _cfgs("xlstm-1.3b")
    rp, pp = _params(ref_ssm.slstm_init, ref_cfg, seed=3)
    x = _x(cfg, 2, s, seed=4)
    ry, rst = ref_ssm.slstm_seq(rp, jnp.asarray(x), ref_cfg)
    py, pst = ssm.slstm_seq(pp, torch.as_tensor(x), cfg)
    _close(py, ry, "y")
    _close(pst, rst, "state")
    rs, ps = _state(ref_ssm.slstm_state(2, ref_cfg))
    ry, rst = ref_ssm.slstm_step(rp, jnp.asarray(x[:, -1]), ref_cfg, rs)
    py, pst = ssm.slstm_step(pp, torch.as_tensor(x[:, -1]), cfg, ps)
    _close(py, ry, "step y")
    _close(pst, rst, "step state")


@pytest.mark.parametrize("s", [5, 300, 512])
def test_mamba_seq_matches_reference(s):
    """300 runs the reference's plain scan, 512 its time-chunked one."""
    ref_cfg, cfg = _cfgs("hymba-1.5b")
    rp, pp = _params(ref_ssm.mamba_init, ref_cfg, seed=5)
    x = _x(cfg, 2, s, seed=6)
    ry, rst = ref_ssm.mamba_seq(rp, jnp.asarray(x), ref_cfg)
    py, pst = ssm.mamba_seq(pp, torch.as_tensor(x), cfg)
    _close(py, ry, "y")
    _close(pst, rst, "state")


def test_mamba_step_continues_seq_as_reference():
    ref_cfg, cfg = _cfgs("hymba-1.5b")
    rp, pp = _params(ref_ssm.mamba_init, ref_cfg, seed=5)
    x = _x(cfg, 2, 12, seed=8)
    rs, ps = _state(ref_ssm.mamba_state(2, ref_cfg))
    _, rst = ref_ssm.mamba_seq(rp, jnp.asarray(x[:, :9]), ref_cfg, rs)
    _, pst = ssm.mamba_seq(pp, torch.as_tensor(x[:, :9]), cfg, ps)
    ys = []
    for t in range(9, 12):
        ry, rst = ref_ssm.mamba_step(rp, jnp.asarray(x[:, t]), ref_cfg, rst)
        py, pst = ssm.mamba_step(pp, torch.as_tensor(x[:, t]), cfg, pst)
        _close(py, ry, f"step {t}")
        _close(pst, rst, f"state {t}")
        ys.append(py)
    # the steps equal the sequence form over the whole input
    full, _ = ssm.mamba_seq(pp, torch.as_tensor(x), cfg, ps)
    torch.testing.assert_close(torch.stack(ys, 1), full[:, 9:], **TOL)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (2, 11, 16)).astype(np.float32)
    w = rng.normal(0, 1, (4, 16)).astype(np.float32)
    prefix = rng.normal(0, 1, (2, 3, 16)).astype(np.float32)
    ro, rp = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(prefix))
    po, pp = ssm._causal_conv(*map(torch.as_tensor, (x, w, prefix)))
    np.testing.assert_allclose(po.numpy(), np.asarray(ro), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(rp))


def test_mamba_constants_are_the_reference_init():
    ref_cfg, cfg = _cfgs("hymba-1.5b")
    rp = ref_ssm.mamba_init(jax.random.PRNGKey(0), ref_cfg)
    const = ssm.mamba_constants(cfg)
    for k, v in const.items():     # log(1..N): the two packages' log differ by an ulp
        np.testing.assert_allclose(v.numpy(), np.asarray(rp[k]), rtol=1e-6, atol=0, err_msg=k)
    spec = ssm.mamba_init(cfg)
    assert {k: tuple(np.shape(v)) for k, v in rp.items()} == {k: s for k, (s, _) in spec.items()}
    assert all(spec[k][1] is None for k in const)

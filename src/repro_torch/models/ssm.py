"""Recurrent sequence mixers: mLSTM / sLSTM (xLSTM) and Mamba-style S6.

Port of ``repro/models/ssm.py`` with the same function names and state
dicts.  Each mixer has a sequence form (``*_seq``, prefill and the
teacher-forced forward) and a single-step form (``*_step``, decode), and
the step form continues from the state the sequence form leaves:

* mLSTM: ``mlstm_seq`` is the chunkwise-parallel form over chunks of
  ``MLSTM_CHUNK`` steps (a padded last chunk has input gate -1e30 and
  forget pre-activation +30 on its pad steps, so they add nothing and
  decay nothing); ``mlstm_step`` is the per-step cell.  State C (B,H,dh,dh),
  n (B,H,dh), m (B,H), m starting at -1e30;
* sLSTM: ``slstm_seq`` is the cell in a Python loop over time, and
  ``slstm_step`` is ``slstm_seq`` at S = 1.  State c, n, h, m (B,H,dh);
* Mamba (S6), hymba's parallel head: ``mamba_seq`` is the causal depthwise
  conv and the selective scan in a Python loop over time, ``mamba_step``
  ``mamba_seq`` at S = 1 with the conv's last K-1 inputs carried.  State
  h (B,Di,N), conv (B,K-1,Di).

Every state is fp32.  The reference's recurrences are ``lax.scan``s under
``jax.jit``, not Pallas kernels, so these are plain PyTorch; its
``jax.checkpoint`` is ``Model``'s ``torch.utils.checkpoint`` around each
layer or group when it trains.  Every form is differentiable; the Mamba
scan writes its step states into a preallocated buffer (``out=``) when no
input takes a gradient and stacks them when one does, the same values.  ``jax.nn.log_sigmoid`` is ``F.logsigmoid`` and
``jax.nn.softplus`` is ``F.softplus``, whose threshold of 20 returns x
there: within an fp32 ulp of jax's x + log1p(exp(-x)).

Parameters are named as the reference's (``mlstm_init`` and the others
give name -> (shape, scale) specs, as ``models.layers`` does).  The
reference casts most weights to the compute type before use; those in
``MAMBA_FP32`` and ``SLSTM_FP32`` it uses uncast, in fp32, so the port
stores them in fp32 in a bf16 model too.  Mamba's ``a_log``, ``d_skip``
and ``dt_bias`` are not drawn: ``mamba_constants`` gives their values.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig

__all__ = [
    "MLSTM_CHUNK", "SCAN_CHUNK", "MAMBA_FP32", "SLSTM_FP32",
    "mlstm_init", "mlstm_state", "mlstm_seq", "mlstm_step",
    "slstm_init", "slstm_state", "slstm_seq", "slstm_step",
    "mamba_init", "mamba_constants", "mamba_state", "mamba_seq", "mamba_step",
]

Spec = Dict[str, Tuple[Tuple[int, ...], Optional[float]]]
State = Dict[str, torch.Tensor]

MLSTM_CHUNK = 256
SCAN_CHUNK = 256     # time steps whose scan inputs mamba_seq makes at once
MAMBA_FP32 = ("conv", "w_dt1", "w_dt2", "dt_bias", "w_bc", "a_log", "d_skip")
SLSTM_FP32 = ("r",)


# ----------------------------------------------------------------------
# mLSTM (matrix memory, exponential gating with stabiliser)
# ----------------------------------------------------------------------
def mlstm_init(cfg: ModelConfig) -> Spec:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.dh
    s = d ** -0.5
    return {"wq": ((d, h * dh), s), "wk": ((d, h * dh), s), "wv": ((d, h * dh), s),
            "wi": ((d, h), s), "wf": ((d, h), s), "w_gate": ((d, h * dh), s),
            "w_out": ((h * dh, d), (h * dh) ** -0.5)}


def mlstm_state(b: int, cfg: ModelConfig, device=None) -> State:
    h, dh = cfg.n_heads, cfg.dh
    f32 = dict(device=device, dtype=torch.float32)
    return {"C": torch.zeros((b, h, dh, dh), **f32), "n": torch.zeros((b, h, dh), **f32),
            "m": torch.full((b, h), -1e30, **f32)}


def _mlstm_cell(state: State, q, k, v, ir, fr) -> Tuple[State, torch.Tensor]:
    """One time step.  q/k/v: (B,H,dh); i/f raw gates: (B,H)."""
    C, n, m = state["C"], state["n"], state["m"]
    dh = q.shape[-1]
    logf = F.logsigmoid(fr)                             # stable forget in log space
    m_new = torch.maximum(logf + m, ir)
    i_g = torch.exp(ir - m_new)[..., None]              # (B,H,1)
    f_g = torch.exp(logf + m - m_new)[..., None]
    k_s = k / (dh ** 0.5)
    C = f_g[..., None] * C + i_g[..., None] * (k_s[..., :, None] * v[..., None, :])
    n = f_g * n + i_g * k_s
    hnum = torch.einsum("bhd,bhde->bhe", q, C)
    hden = torch.einsum("bhd,bhd->bh", q, n).abs()
    hden = torch.maximum(hden, torch.exp(-m_new))[..., None]
    return {"C": C, "n": n, "m": m_new}, hnum / hden


def _mlstm_chunk(state: State, q, k, v, ir, lf, dh_scale: float) -> Tuple[State, torch.Tensor]:
    """Chunkwise-parallel mLSTM (stabilised): one chunk of T steps as dense
    products; the matrix state is touched only at the chunk's ends.
    q/k/v: (B,H,T,dh); ir/lf: (B,H,T) raw input gate / log-sigmoid forget."""
    C0, n0, m0 = state["C"], state["n"], state["m"]
    t = q.shape[2]
    ks = k * dh_scale
    b_cum = torch.cumsum(lf, dim=-1)                      # (B,H,T) inclusive
    # intra-chunk log-weights: logW[t,s] = b_t - b_s + i_s   (s <= t)
    logw = b_cum[..., :, None] - b_cum[..., None, :] + ir[..., None, :]
    tri = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    logw = logw.masked_fill(~tri, -float("inf"))
    g = b_cum + m0[..., None]                             # inter-chunk decay
    m_t = torch.maximum(g, logw.amax(-1))                 # stabiliser per step
    w = torch.exp(logw - m_t[..., None])                  # (B,H,T,T)
    inter = torch.exp(g - m_t)                            # (B,H,T)

    scores = torch.einsum("bhtd,bhsd->bhts", q, ks)
    h_num = torch.einsum("bhts,bhsd->bhtd", w * scores, v)
    h_num = h_num + inter[..., None] * torch.einsum("bhtd,bhde->bhte", q, C0)
    denom = torch.einsum("bhts,bhts->bht", w, scores)
    denom = denom + inter * torch.einsum("bhtd,bhd->bht", q, n0)
    h = h_num / torch.maximum(denom.abs(), torch.exp(-m_t))[..., None]

    # chunk-final state
    gT = b_cum[..., -1:] + m0[..., None]                  # (B,H,1)
    logwT = b_cum[..., -1:] - b_cum + ir                  # (B,H,T)
    m_new = torch.maximum(gT[..., 0], logwT.amax(-1))
    wT = torch.exp(logwT - m_new[..., None])
    decay0 = torch.exp(gT[..., 0] - m_new)                # (B,H)
    C = decay0[..., None, None] * C0 + torch.einsum("bht,bhtd,bhte->bhde", wT, ks, v)
    n = decay0[..., None] * n0 + torch.einsum("bht,bhtd->bhd", wT, ks)
    return {"C": C, "n": n, "m": m_new}, h


def _mlstm_inputs(p, x: torch.Tensor, cfg: ModelConfig):
    """q, k, v (..., H, dh) and the raw i, f gates (..., H), fp32, from x
    (..., D) in the compute type."""
    h, dh = cfg.n_heads, cfg.dh
    dt = x.dtype
    lead = x.shape[:-1]
    q, k, v = ((x @ p[w].to(dt)).reshape(*lead, h, dh).float() for w in ("wq", "wk", "wv"))
    ir = (x @ p["wi"].to(dt)).float()
    fr = (x @ p["wf"].to(dt)).float()
    return q, k, v, ir, fr


def _mlstm_out(p, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    y = y * F.silu(x @ p["w_gate"].to(x.dtype))
    return y @ p["w_out"].to(x.dtype)


def mlstm_seq(p, x: torch.Tensor, cfg: ModelConfig, state: Optional[State] = None
              ) -> Tuple[torch.Tensor, State]:
    """x: (B,S,D) -> (y (B,S,D), final state).  Chunkwise-parallel form."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.dh
    q, k, v, ir, fr = _mlstm_inputs(p, x, cfg)
    if state is None:
        state = mlstm_state(b, cfg, x.device)
    ch = min(MLSTM_CHUNK, s)
    pad = (-s) % ch
    if pad:
        # i gate -1e30 -> padded steps contribute nothing; f raw +30 -> no decay
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        ir = F.pad(ir, (0, 0, 0, pad), value=-1e30)
        fr = F.pad(fr, (0, 0, 0, pad), value=30.0)
    lf = F.logsigmoid(fr)
    q, k, v = (a.transpose(1, 2) for a in (q, k, v))      # (B,H,S,dh)
    ir, lf = ir.transpose(1, 2), lf.transpose(1, 2)       # (B,H,S)
    hs = []
    for c0 in range(0, s + pad, ch):
        sl = slice(c0, c0 + ch)
        state, hc = _mlstm_chunk(state, q[:, :, sl], k[:, :, sl], v[:, :, sl], ir[:, :, sl],
                                 lf[:, :, sl], dh ** -0.5)
        hs.append(hc)
    y = torch.cat(hs, dim=2).transpose(1, 2)[:, :s].reshape(b, s, h * dh).to(x.dtype)
    return _mlstm_out(p, y, x), state


def mlstm_step(p, x: torch.Tensor, cfg: ModelConfig, state: State
               ) -> Tuple[torch.Tensor, State]:
    """x: (B,D) one token -> (y (B,D), state).  The O(1) cell, on the state
    contract the chunkwise form shares."""
    b = x.shape[0]
    state, hh = _mlstm_cell(state, *_mlstm_inputs(p, x, cfg))
    return _mlstm_out(p, hh.reshape(b, -1).to(x.dtype), x), state


# ----------------------------------------------------------------------
# sLSTM (scalar memory with recurrent hidden mixing, per head)
# ----------------------------------------------------------------------
def slstm_init(cfg: ModelConfig) -> Spec:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.dh
    s = d ** -0.5
    return {"wz": ((d, h * dh), s), "wi": ((d, h * dh), s), "wf": ((d, h * dh), s),
            "wo": ((d, h * dh), s),
            "r": ((h, dh, dh), dh ** -0.5),              # recurrent block-diagonal mixing
            "w_out": ((h * dh, d), (h * dh) ** -0.5)}


def slstm_state(b: int, cfg: ModelConfig, device=None) -> State:
    shape = (b, cfg.n_heads, cfg.dh)
    f32 = dict(device=device, dtype=torch.float32)
    return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "h": torch.zeros(shape, **f32), "m": torch.full(shape, -1e30, **f32)}


def _slstm_cell(r: torch.Tensor, state: State, z_in, i_in, f_in, o_in
                ) -> Tuple[State, torch.Tensor]:
    c, n, hid, m = state["c"], state["n"], state["h"], state["m"]
    rec = torch.einsum("bhd,hde->bhe", hid, r)
    z = torch.tanh(z_in + rec)
    o = torch.sigmoid(o_in + rec)
    logf = F.logsigmoid(f_in + rec)
    i_raw = i_in + rec
    m_new = torch.maximum(logf + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(logf + m - m_new)
    c = f_g * c + i_g * z
    n = f_g * n + i_g
    hid = o * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "h": hid, "m": m_new}, hid


def slstm_seq(p, x: torch.Tensor, cfg: ModelConfig, state: Optional[State] = None
              ) -> Tuple[torch.Tensor, State]:
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.dh
    dt = x.dtype
    z_in, i_in, f_in, o_in = ((x @ p[w].to(dt)).reshape(b, s, h, dh).float()
                              for w in ("wz", "wi", "wf", "wo"))
    if state is None:
        state = slstm_state(b, cfg, x.device)
    hs = []
    for t in range(s):
        state, hid = _slstm_cell(p["r"], state, z_in[:, t], i_in[:, t], f_in[:, t], o_in[:, t])
        hs.append(hid)
    y = torch.stack(hs, dim=1).reshape(b, s, h * dh).to(dt)
    return y @ p["w_out"].to(dt), state


def slstm_step(p, x: torch.Tensor, cfg: ModelConfig, state: State
               ) -> Tuple[torch.Tensor, State]:
    y, state = slstm_seq(p, x[:, None, :], cfg, state)
    return y[:, 0], state


# ----------------------------------------------------------------------
# Mamba-style selective SSM (S6) -- the hymba parallel head
# ----------------------------------------------------------------------
def mamba_init(cfg: ModelConfig) -> Spec:
    d = cfg.d_model
    di = d            # inner dim of the parallel SSM path
    n = cfg.ssm_state
    r = max(1, d // 16)
    return {"w_in": ((d, 2 * di), d ** -0.5), "conv": ((cfg.ssm_conv, di), 0.1),
            "w_dt1": ((di, r), di ** -0.5), "w_dt2": ((r, di), r ** -0.5),
            "dt_bias": ((di,), None), "w_bc": ((di, 2 * n), di ** -0.5),
            "a_log": ((di, n), None), "d_skip": ((di,), None),
            "w_out": ((di, d), di ** -0.5)}


def mamba_constants(cfg: ModelConfig, device=None) -> Dict[str, torch.Tensor]:
    """The initial values the reference sets rather than draws: ``a_log``
    log(1..N) on every inner channel, ``d_skip`` ones (``dt_bias`` zeros)."""
    di, n = cfg.d_model, cfg.ssm_state
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {"a_log": torch.log(a).expand(di, n).contiguous(),
            "d_skip": torch.ones(di, dtype=torch.float32, device=device),
            "dt_bias": torch.zeros(di, dtype=torch.float32, device=device)}


def mamba_state(b: int, cfg: ModelConfig, device=None) -> State:
    di, n, kc = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    f32 = dict(device=device, dtype=torch.float32)
    return {"h": torch.zeros((b, di, n), **f32),
            "conv": torch.zeros((b, kc - 1, di), **f32)}   # trailing inputs for the conv


def _causal_conv(x: torch.Tensor, w: torch.Tensor, prefix: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B,S,Di), w: (K,Di), prefix: (B,K-1,Di)."""
    kc, s = w.shape[0], x.shape[1]
    xp = torch.cat([prefix, x], dim=1)
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, kc):
        out = out + xp[:, i:i + s, :] * w[i]
    new_prefix = xp[:, xp.shape[1] - (kc - 1):, :] if kc > 1 else prefix
    return out, new_prefix


def mamba_seq(p, x: torch.Tensor, cfg: ModelConfig, state: Optional[State] = None
              ) -> Tuple[torch.Tensor, State]:
    """The selective scan h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t, y_t =
    h_t . C_t, one step at a time in fp32; each SCAN_CHUNK steps' decays and
    inputs are made together, and the step is one ``addcmul``, written in
    place into the chunk's state buffer unless autograd records it."""
    b, s, _ = x.shape
    n = cfg.ssm_state
    dt_ = x.dtype
    if state is None:
        state = mamba_state(b, cfg, x.device)
    x_in, z = (x @ p["w_in"].to(dt_)).chunk(2, dim=-1)      # (B,S,Di) each
    x_c, conv_state = _causal_conv(x_in.float(), p["conv"], state["conv"].float())
    x_c = F.silu(x_c)
    dt = F.softplus(x_c @ p["w_dt1"] @ p["w_dt2"] + p["dt_bias"])   # (B,S,Di)
    bc = x_c @ p["w_bc"]                                    # (B,S,2N)
    b_in, c_out = bc[..., :n], bc[..., n:]
    a = -torch.exp(p["a_log"])                              # (Di, N)
    h = state["h"].float()
    ys = []
    for t0 in range(0, s, SCAN_CHUNK):
        sl = slice(t0, min(t0 + SCAN_CHUNK, s))
        da = torch.exp(dt[:, sl, :, None] * a)              # (B,T,Di,N)
        u = (dt[:, sl] * x_c[:, sl])[..., None] * b_in[:, sl, None, :]
        if torch.is_grad_enabled() and (u.requires_grad or da.requires_grad or h.requires_grad):
            steps = []
            for t in range(da.shape[1]):
                h = torch.addcmul(u[:, t], da[:, t], h)
                steps.append(h)
            hs = torch.stack(steps, dim=1)
        else:
            hs = torch.empty_like(da)
            for t in range(da.shape[1]):
                h = torch.addcmul(u[:, t], da[:, t], h, out=hs[:, t])
        ys.append(torch.einsum("btdn,btn->btd", hs, c_out[:, sl]))
        h = hs[:, -1].clone()
        del da, u, hs
    y = torch.cat(ys, dim=1) + p["d_skip"] * x_c            # (B,S,Di)
    y = (y * F.silu(z.float())).to(dt_)
    return y @ p["w_out"].to(dt_), {"h": h, "conv": conv_state}


def mamba_step(p, x: torch.Tensor, cfg: ModelConfig, state: State
               ) -> Tuple[torch.Tensor, State]:
    y, state = mamba_seq(p, x[:, None, :], cfg, state)
    return y[:, 0], state

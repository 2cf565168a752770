"""Shared transformer building blocks, in PyTorch.

Port of ``repro/models/layers.py`` (attention, dense and MoE feed-forward).
Conventions as there:

* activations: (B, S, D); attention heads grouped GQA-style (KV, G, dh)
  with G = n_heads // n_kv_heads;
* prefill attention runs over 128-query chunks with the softmax in fp32,
  so the (S, S) score matrix never materialises, with an optional sliding
  window and attention softcap.  It is plain PyTorch, as the reference's is
  XLA code and not a Pallas kernel;
* decode attention is not here: ``Model.decode_step`` calls
  :func:`repro_torch.kernels.ops.decode_attention` (the hand-written kernel
  on a card, its plain version on the CPU), the contract of the
  reference's ``decode_attention_xla`` with its window and softcap;
* the MoE feed-forward (``moe_ffn``) is the reference's sort-based
  dispatch with per-sequence capacity, in plain PyTorch as the reference's
  is XLA code;
* the int8 KV cache's per-vector quantisation (``quantize_kv``,
  ``dequantize_kv``), bit for bit the reference's.

Under a model axis (``dist.tensor_parallel``) the same functions run one
rank's share, in training and in serving alike: ``attn_qkv``/``attn_out``
over the rank's heads (the config ``ModelAxis.attn_cfg`` and the rank's
blocks of the weights), ``moe_ffn`` over the rank's experts (``axis``),
and ``quantize_kv`` on K/V already gathered over the heads, since the
cache is whole on every rank.

Weights are parameter dictionaries keyed by the reference's names.  The
reference keeps fp32 masters and casts them to the compute type before
every use; the port stores them in that type already, which gives the same
numbers (see ``models.model``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ref import lowest_id_topk

__all__ = [
    "NEG", "CHUNK", "rms_norm", "rope", "softcap", "quantize_kv", "dequantize_kv",
    "flash_attention",
    "attn_init", "attn_qkv", "attn_out", "mlp_init", "mlp", "moe_init", "moe_ffn",
    "drop_log_paused",
]

NEG = -2.0e38
CHUNK = 128   # queries per prefill attention chunk, as the reference's default


# ----------------------------------------------------------------------
# basics
# ----------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # variance in f32; the normalisation itself stays in the input dtype
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale.to(x.dtype))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq                       # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 quantisation over the head dim, as the
    reference's: x (..., dh) -> (int8 (..., dh), f32 scale (...)), scale =
    max|x| / 127 floored at 1e-8; x / scale (a division, not a product with
    the reciprocal) rounded half to even, as ``jnp.round``, and clipped to
    +-127."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def flash_attention(
    q: torch.Tensor,         # (B, Sq, KV, G, dh)
    k: torch.Tensor,         # (B, Sk, KV, dh)
    v: torch.Tensor,         # (B, Sk, KV, dh)
    window=None,             # None = full; an int w keeps k_pos > q_pos - w
    attn_softcap: float = 0.0,
    causal: bool = True,     # False: every query sees every key (the window still applies)
) -> torch.Tensor:
    """Attention over query chunks of ``CHUNK``, causal unless ``causal`` is
    False (the encoder's and cross-attention's); scores per chunk are
    (B, KV, G, CHUNK, Sk) in fp32, soft-capped before the mask as the
    reference's.  Returns (B, Sq, KV, G, dh) in q's type."""
    sq, sk = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(sk, device=q.device)
    outs = []
    for c0 in range(0, sq, CHUNK):
        qc = q[:, c0:c0 + CHUNK]
        scores = softcap(torch.einsum("bqkgd,bskd->bkgqs", qc.float(), kf) * scale, attn_softcap)
        q_pos = c0 + torch.arange(qc.shape[1], device=q.device)
        masked = (q_pos[:, None] < k_pos[None, :] if causal
                  else torch.zeros((qc.shape[1], sk), dtype=torch.bool, device=q.device))
        if window is not None:
            masked |= k_pos[None, :] <= q_pos[:, None] - window
        scores.masked_fill_(masked, NEG)
        w = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", w, vf).to(q.dtype))
    return torch.cat(outs, dim=1)


def attn_init(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], Optional[float]]]:
    """Attention weights of one layer: name -> (shape, scale), as the
    reference draws them (N(0, 1) * scale); scale None means zeros."""
    d, dh, h, kvh = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    s = d ** -0.5
    p = {"wq": ((d, h * dh), s), "wk": ((d, kvh * dh), s),
         "wv": ((d, kvh * dh), s), "wo": ((h * dh, d), (h * dh) ** -0.5)}
    if cfg.qk_norm:
        p["q_norm"] = ((dh,), None)
        p["k_norm"] = ((dh,), None)
    return p


def attn_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project + qk-norm + rope.  x: (B,S,D) -> q (B,S,KV,G,dh), k/v (B,S,KV,dh)."""
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    g = h // kvh
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(b, s, h, dh)
    k = (x @ p["wk"].to(dt)).reshape(b, s, kvh, dh)
    v = (x @ p["wv"].to(dt)).reshape(b, s, kvh, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q.reshape(b, s, kvh, g, dh), k, v


def attn_out(p, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s = o.shape[:2]
    return o.reshape(b, s, cfg.n_heads * cfg.dh) @ p["wo"].to(o.dtype)


# ----------------------------------------------------------------------
# feed-forward
# ----------------------------------------------------------------------
def mlp_init(d: int, f: int) -> Dict[str, Tuple[Tuple[int, ...], Optional[float]]]:
    return {"w_gate": ((d, f), d ** -0.5), "w_up": ((d, f), d ** -0.5),
            "w_down": ((f, d), f ** -0.5)}


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)



# ----------------------------------------------------------------------
# Mixture of Experts (sort-based dispatch with capacity)
# ----------------------------------------------------------------------
# Off (None) by default.  Set to a list, and each moe_ffn call appends its
# count of dropped (token, expert) assignments as a device tensor (no host
# sync); the measurement reads the list afterwards.
moe_drop_log: Optional[list] = None


@contextlib.contextmanager
def drop_log_paused():
    """``moe_drop_log`` off inside the block: a layer recomputed for its
    backward pass (``torch.utils.checkpoint``) logs its drops once, in the
    forward."""
    global moe_drop_log
    saved, moe_drop_log = moe_drop_log, None
    try:
        yield
    finally:
        moe_drop_log = saved


def moe_init(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], Optional[float]]]:
    """The routed experts' weights (the shared expert, if any, is a
    :func:`mlp_init` of width d_ff beside them, under ``shared``)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": ((d, e), d ** -0.5), "w_gate": ((e, d, f), d ** -0.5),
            "w_up": ((e, d, f), d ** -0.5), "w_down": ((e, f, d), f ** -0.5)}


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, group=None, axis=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with per-sequence capacity, as the reference's
    ``moe_ffn``: router softmax in fp32, top k (equal probabilities in
    ascending expert order, ``jax.lax.top_k``'s rule) renormalised; each row
    sorts its S*K (expert, token) assignments by expert, stably, so a
    sequence's tokens fill an expert's C = int(max(1, capacity_factor * S *
    K / E)) slots in position order and a padded batch's pad tail is what
    overflows; the (B, E, C, D) buffer runs through the experts' SwiGLU as
    three batched einsums; each token sums its K weighted slots (in its
    top-k order, without atomics).  Returns (output, Switch aux loss).

    ``group``: a process group whose ranks each hold an equal share of the
    batch's rows.  The routing density is then averaged over it, so that
    the mean of the ranks' aux losses is the whole batch's (the product of
    the batch's density and its mean probabilities, as GSPMD computes it
    over the global batch), and so are their gradients.

    ``axis``: a ``dist.tensor_parallel.ModelAxis``.  Every rank routes
    every token (the tokens are replicated over the model axis, so the
    drops, ``moe_drop_log`` and the aux loss are the same on each); when
    the axis splits the experts, ``p``'s expert weights are this rank's
    E / n experts, each rank fills and runs only their slots of the
    buffer, and the tokens' weighted sums are summed over the axis (the
    shared expert's too when the axis splits its MLP)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k_experts
    dt = x.dtype
    dev = x.device

    probs = torch.softmax((x @ p["router"].to(dt)).float(), dim=-1)       # (B, S, E)
    neg_top, topi = lowest_id_topk(-probs.reshape(b * s, e), k)
    topv, topi = -neg_top.reshape(b, s, k), topi.reshape(b, s, k).long()
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch-style) over the whole batch
    density = torch.zeros(e, device=dev).index_add_(
        0, topi.reshape(-1), torch.ones(b * s * k, device=dev)) / (b * s * k)
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(density, group=group)
        density = density / dist.get_world_size(group)
    aux = e * torch.sum(density * probs.mean((0, 1)))

    cap = int(max(1, cfg.capacity_factor * s * k / e))
    e_flat = topi.reshape(b, s * k)
    e_sort, order = torch.sort(e_flat, dim=-1, stable=True)
    t_sort = order // k                                                   # token of each slot
    first = torch.searchsorted(e_sort, e_sort, side="left")
    slot = torch.arange(s * k, device=dev) - first
    keep = slot < cap
    if moe_drop_log is not None:
        moe_drop_log.append((~keep).sum())
    slot_c = torch.clamp_max(slot, cap - 1)
    rows = torch.arange(b, device=dev)[:, None].expand(b, s * k)

    # this rank's experts [e0, e0 + n_local): all E of them unless a model axis splits them
    split = axis is not None and axis.split["experts"]
    n_local = e // axis.n if split else e
    e0 = axis.rank * n_local if split else 0
    enter = axis.enter if split else (lambda t: t)
    leave = axis.leave if split else (lambda t: t)
    mine = keep & (e_sort >= e0) & (e_sort < e0 + n_local)
    xs = torch.where(mine[..., None], enter(x)[rows, t_sort],
                     torch.zeros((), dtype=dt, device=dev))
    buf = torch.zeros((b, n_local, cap, d), dtype=dt, device=dev)
    buf.index_put_((rows, torch.clamp(e_sort - e0, 0, n_local - 1), slot_c), xs,
                   accumulate=True)

    h = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"].to(dt))) * \
        torch.einsum("becd,edf->becf", buf, p["w_up"].to(dt))
    y_buf = torch.einsum("becf,efd->becd", h, p["w_down"].to(dt))

    # back in each token's own top-k order: assignment i went to sorted place inv[i]
    inv = torch.argsort(order, dim=-1)
    slot_of = torch.gather(slot_c, 1, inv)
    mine_of = torch.gather(mine, 1, inv)
    w = (enter(topv).reshape(b, s * k) * mine_of).to(dt)
    y = y_buf[rows, torch.clamp(e_flat - e0, 0, n_local - 1), slot_of] * w[..., None]
    out = leave(y.reshape(b, s, k, d).sum(2))                             # (B, S, D)
    if cfg.moe_shared_expert:
        if axis is not None and axis.split["mlp"]:
            out = out + axis.leave(mlp(p["shared"], axis.enter(x).reshape(b * s, d))
                                   .reshape(b, s, d))
        else:
            out = out + mlp(p["shared"], x.reshape(b * s, d)).reshape(b, s, d)
    return out, aux

"""Shared transformer building blocks, in PyTorch.

Port of ``repro/models/layers.py`` (dense parts).  Conventions as there:

* activations: (B, S, D); attention heads grouped GQA-style (KV, G, dh)
  with G = n_heads // n_kv_heads;
* prefill attention runs over 128-query chunks with the softmax in fp32,
  so the (S, S) score matrix never materialises.  It is plain PyTorch, as
  the reference's is XLA code and not a Pallas kernel;
* decode attention is not here: ``Model.decode_step`` calls
  :func:`repro_torch.kernels.ops.decode_attention` (the hand-written kernel
  on a card, its plain version on the CPU), the contract of the
  reference's ``decode_attention_xla`` without a window or softcap.

Weights are parameter dictionaries keyed by the reference's names.  The
reference keeps fp32 masters and casts them to the compute type before
every use; the port stores them in that type already, which gives the same
numbers (see ``models.model``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig

__all__ = [
    "NEG", "CHUNK", "rms_norm", "rope", "softcap", "flash_attention",
    "attn_init", "attn_qkv", "attn_out", "mlp_init", "mlp",
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


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def flash_attention(
    q: torch.Tensor,         # (B, Sq, KV, G, dh)
    k: torch.Tensor,         # (B, Sk, KV, dh)
    v: torch.Tensor,         # (B, Sk, KV, dh)
) -> torch.Tensor:
    """Causal attention over query chunks of ``CHUNK``; scores per chunk are
    (B, KV, G, CHUNK, Sk) in fp32.  Returns (B, Sq, KV, G, dh) in q's type.
    Full attention only (no window, no softcap): the port's model refuses
    configs that need them."""
    sq, sk = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(sk, device=q.device)
    outs = []
    for c0 in range(0, sq, CHUNK):
        qc = q[:, c0:c0 + CHUNK]
        scores = torch.einsum("bqkgd,bskd->bkgqs", qc.float(), kf) * scale
        q_pos = c0 + torch.arange(qc.shape[1], device=q.device)
        scores.masked_fill_(q_pos[:, None] < k_pos[None, :], NEG)
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


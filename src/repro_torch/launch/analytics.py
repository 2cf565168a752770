"""Analytic cost model: trip-count-exact FLOPs / HBM / collective bytes.

Port of ``repro/launch/analytics.py``: the same arithmetic over the config,
the shape and the mesh factorisation (n_data x n_model), so the same floats
bit for bit.  The reference wrote it because XLA's ``cost_analysis`` counts
a scanned loop body once; the port's dry-run records it beside its own
traced FLOPs (``torch.utils.flop_counter``, which counts every iteration)
and derives the roofline terms (``launch/roofline.py``) from it.

Its traffic model is the reference's and is not corrected here.  For
example a decode step counts the weights twice (``w_traffic = 2 * p_bf16 /
n_model``: FSDP writes the gathered copy, then reads it), where one card
that holds them reads them once.

Conventions: FLOPs are 2·m·n·k per matmul; everything is derived from the
config + shape + mesh factorisation.  All outputs GLOBAL (sum over devices)
except ``coll_bytes_per_dev``, the per-device payload (what the link sees).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..configs.base import ModelConfig, ShapeSpec

__all__ = ["analytic_cost", "AnalyticCost"]

BF16 = 2
F32 = 4


def _eff_attended(s: int, w: int) -> float:
    """Sum over query positions of attended width, causal with window w."""
    if w >= s:
        return s * (s + 1) / 2.0
    return w * s - w * (w - 1) / 2.0


def _per_layer_windows(cfg: ModelConfig, s: int):
    if cfg.layer_pattern == "local_global":
        return [cfg.sliding_window if i % 2 == 0 else s for i in range(cfg.n_layers)]
    if cfg.layer_pattern == "hymba":
        return [
            s if i in cfg.global_layers else cfg.sliding_window
            for i in range(cfg.n_layers)
        ]
    return [s] * cfg.n_layers


def _proj_flops_per_token(cfg: ModelConfig) -> float:
    """Per-layer projection (non-attention-score) matmul flops per token."""
    d, dh, h, kv, f = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    hdh, kvdh = h * dh, kv * dh
    attn = 2 * d * hdh + 2 * 2 * d * kvdh + 2 * hdh * d
    if cfg.family == "ssm":
        # mLSTM-ish block: q/k/v/gate + out projections + cell update
        cell = 6 * dh * d          # 6·dh² per head × H = 6·dh·(H·dh)=6·dh·D
        return 10 * d * hdh + cell
    if cfg.family == "hybrid":
        di, n, r = d, cfg.ssm_state, max(1, d // 16)
        mamba = 2 * d * 2 * di + 4 * di * r + 2 * di * 2 * n + 6 * di * n + 2 * di * d
        return attn + mamba + 6 * d * f
    if cfg.is_moe:
        ff = 2 * d * cfg.n_experts + 6 * d * f * cfg.top_k_experts
        if cfg.moe_shared_expert:
            ff += 6 * d * f
        return attn + ff
    return attn + 6 * d * f


@dataclasses.dataclass
class AnalyticCost:
    flops: float                 # global
    hbm_bytes: float             # global (sum of per-device traffic)
    coll_bytes_per_dev: float    # payload bytes through one chip's links
    detail: Dict[str, float]

    def to_dict(self):
        return dataclasses.asdict(self)


def analytic_cost(
    cfg: ModelConfig, shape: ShapeSpec, n_data: int, n_model: int
) -> AnalyticCost:
    chips = n_data * n_model
    b, s = shape.global_batch, shape.seq_len
    d, dh, h, kv, v = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size
    L = cfg.n_layers
    n_params = cfg.n_params()
    n_active = cfg.n_active_params()
    kvdh = kv * dh
    t_global = b * s
    t_loc = t_global / n_data    # tokens per data shard

    proj_tok = _proj_flops_per_token(cfg)

    # ----- FLOPs ------------------------------------------------------
    if shape.kind in ("train", "prefill"):
        attn_fl = 0.0
        if cfg.family != "ssm":
            for w in _per_layer_windows(cfg, s):
                attn_fl += 4 * b * h * dh * _eff_attended(s, w)
        enc_fl = 0.0
        if cfg.is_encdec:
            fe = cfg.frontend_len
            enc_fl = cfg.n_enc_layers * (
                b * fe * (2 * d * h * dh * 2 + 2 * 2 * d * kvdh + 4 * d * cfg.d_ff)
                + 4 * b * h * dh * fe * fe      # bidirectional scores
            )
            # decoder cross-attention scores
            attn_fl += L * 4 * b * h * dh * fe * s
        layer_fl = L * proj_tok * t_global + attn_fl + enc_fl
        head_fl = 2 * d * v * t_global
        if shape.kind == "train":
            # layers: fwd + 2·bwd + 1·remat-refwd = 4x ; head/loss: 3x
            flops = 4 * layer_fl + 3 * head_fl
        else:
            flops = layer_fl + head_fl
    else:  # decode: one token per sequence
        attn_fl = 0.0
        if cfg.family != "ssm":
            for w in _per_layer_windows(cfg, s):
                attn_fl += 4 * b * h * dh * min(s, w)
        if cfg.is_encdec:
            attn_fl += L * 4 * b * h * dh * cfg.frontend_len
        flops = L * proj_tok * b + attn_fl + 2 * d * v * b

    # ----- HBM traffic (per device, then x chips) ---------------------
    p_bf16 = n_params * BF16
    if shape.kind == "train":
        # gathered bf16 weights written+read on every device, 3 passes
        # (fwd, remat, bwd); TP keeps 1/n_model of each tensor per device.
        w_traffic = 3 * 2 * p_bf16 / n_model
        # master/opt update on the owned shard only (read p,m,v + write p,m,v)
        opt_traffic = 24 * n_params / chips + 8 * n_params / chips  # + grad f32 rw
        # activations: ~20 residual-stream touches per layer (fwd+bwd+remat)
        act = 20 * L * t_loc * d * BF16
        # flash-attention KV streaming: K+V re-read once per query chunk
        chunk = 512
        kv_stream = 0.0
        if cfg.family != "ssm":
            n_chunks = max(1, s // chunk)
            for w in _per_layer_windows(cfg, s):
                eff = min(w, s)
                kv_stream += 3 * (b / n_data) * n_chunks * eff * kvdh * 2 * BF16
        logits_traffic = 4 * t_loc * (v / n_model) * F32 * 3  # fwd w, bwd r/w x3 passes
        per_dev = w_traffic + opt_traffic + act + kv_stream + logits_traffic
    elif shape.kind == "prefill":
        w_traffic = 2 * p_bf16 / n_model
        act = 8 * L * t_loc * d * BF16
        chunk = 512
        kv_stream = 0.0
        if cfg.family != "ssm":
            n_chunks = max(1, s // chunk)
            for w in _per_layer_windows(cfg, s):
                kv_stream += 1.5 * (b / n_data) * n_chunks * min(w, s) * kvdh * 2 * BF16
        cache_write = 2 * L * t_loc * kvdh * BF16
        per_dev = w_traffic + act + kv_stream + cache_write + 2 * t_loc * (v / n_model) * F32
    else:  # decode
        b_loc = b / n_data if b >= n_data else b
        # weights: every device reads the gathered bf16 copy once per step
        w_traffic = 2 * p_bf16 / n_model
        cache_rw = 0.0
        if cfg.family != "ssm":
            # cache sequence dim is sharded over `model` (batch-sharded case)
            # or over the data axes (B < n_data) — dist/sharding.cache_sharding
            seq_shard = n_model if b >= n_data else n_data
            # int8 cache halves the bytes (+2/dh f32 scale overhead)
            kv_bytes = (1 + 4.0 / dh) if cfg.kv_cache_int8 else BF16
            for w in _per_layer_windows(cfg, s):
                span = min(w, s)
                span_loc = span / seq_shard
                cache_rw += 2 * b_loc * kv * span_loc * dh * kv_bytes
        if cfg.family in ("ssm", "hybrid"):
            # recurrent states read+write
            if cfg.family == "ssm":
                cache_rw += 2 * L * b_loc * h * dh * dh * F32
            else:
                cache_rw += 2 * L * b_loc * d * cfg.ssm_state * F32
        per_dev = w_traffic + cache_rw + b_loc * d * L * 10 * BF16
    hbm = per_dev * chips

    # ----- collective bytes per device ---------------------------------
    if shape.kind == "train":
        # fsdp all-gather x3 + grad reduce-scatter (over data axes), TP dim
        # excluded from gather size; ring factor (n-1)/n ~ 1
        ag = 3 * p_bf16 / n_model
        rs = n_params * F32 / n_model
        # TP all-reduce: 2 per layer per pass (attn out + ffn out), 3 passes,
        # ring all-reduce moves 2x payload.  MoE layers replace the FFN
        # all-reduce with the expert all-to-all -> only 1 AR/layer.
        ar_per_layer = 1 if cfg.is_moe else 2
        tp_ar = 3 * ar_per_layer * 2 * L * t_loc * d * BF16 if n_model > 1 else 0.0
        a2a = 0.0
        if cfg.is_moe:
            a2a = 2 * 2 * 2 * L * t_loc * d * BF16   # dispatch+combine, fwd+bwd
        coll = ag + rs + tp_ar + a2a
    elif shape.kind == "prefill":
        ag = p_bf16 / n_model
        tp_ar = 2 * 2 * L * t_loc * d * BF16 if n_model > 1 else 0.0
        a2a = 2 * 2 * L * t_loc * d * BF16 if cfg.is_moe else 0.0
        coll = ag + tp_ar + a2a
    else:
        b_loc = b / n_data if b >= n_data else b
        ag = p_bf16 / n_model                       # weight gather per step
        tp_ar = 2 * 2 * L * b_loc * d * BF16 if n_model > 1 else 0.0
        a2a = 2 * 2 * L * b_loc * d * BF16 if cfg.is_moe else 0.0
        # sequence-parallel cache (B < n_data): softmax partial reductions
        seq_ar = 2 * L * b * h * 4 * F32 if b < n_data else 0.0
        coll = ag + tp_ar + a2a + seq_ar

    detail = {
        "proj_flops_per_token_per_layer": proj_tok,
        "n_params": float(n_params),
        "n_active_params": float(n_active),
        "tokens": float(t_global if shape.kind != "decode" else b),
    }
    return AnalyticCost(
        flops=float(flops), hbm_bytes=float(hbm),
        coll_bytes_per_dev=float(coll), detail=detail,
    )

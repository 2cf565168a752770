"""The language model of every family, as an ``nn.Module``.

Port of ``repro/models/model.py`` for ``family="dense"``, ``"moe"``,
``"hybrid"``, ``"ssm"``, ``"encdec"`` and ``"vlm"`` (qwen3-14b; gemma2-2b
with its alternating sliding windows and softcaps; olmoe-1b-7b and
llama4-scout with routed, and shared, experts; hymba-1.5b, attention and a
Mamba head side by side in each layer, sliding windows but for its global
layers; xlstm-1.3b, groups of one sLSTM and ``slstm_every - 1`` mLSTM
blocks; seamless-m4t-large-v2, a bidirectional encoder over stub frame
embeddings and decoder layers that cross-attend to it; internvl2-76b, stub
patch embeddings prepended to a dense backbone's prompt), with or without
the int8 KV cache:

    model = Model(cfg, device="cuda").init(torch.Generator("cuda").manual_seed(0))
    logits, aux = model.forward({"tokens": tokens})
    total, metrics = model.trainable().loss({"tokens": tokens, "labels": labels})
    logits, cache = model.prefill({"tokens": tokens}, max_len, lengths=lengths)
    logits, cache = model.decode_step(cache, next_tokens, lengths)

An encdec batch also holds ``"frames"`` (B, F, D) and a vlm batch
``"patches"`` (B, P, D), F and P the config's ``frontend_len``.  A vlm
model's cache holds P + S positions, and its ``lengths`` count the
prefix: prefill takes the prompt lengths and gathers each row's logits at
``P + lengths - 1``; ``decode_step`` takes the cache fill, P + the prompt
length + the tokens decoded so far.  An encdec prefill fills the cross
cache ``xk``/``xv`` (B, F, KV, dh), the keys and values of the encoder's
output under layer 0's ``xattn.wk``/``wv``, which every decoder layer
attends to (the reference's backbone simplification).

Parameters keep the reference's names and shapes, one module per layer
(``layers.<i>.attn.wq`` is row i of the reference's stacked
``params["layers"]["attn"]["wq"]``; xLSTM's ``blocks.<g>.mlstm.<j>.wq`` is
``params["blocks"]["mlstm"]["wq"][g, j]``), and the layer scans are Python
loops.

Differences from the reference, each giving the same numbers:

* A serving model stores its weights in ``cfg.dtype`` on the device.  The
  reference keeps fp32 masters and casts them to ``cfg.dtype`` before every
  use (its ``_embed``, ``_logits``, ``attn_qkv``, ``attn_out``, ``mlp``,
  ``rms_norm``), so storing the cast values gives the same products at half
  the memory in bf16.  The recurrences' weights that the reference uses
  uncast (``ssm.MAMBA_FP32``, ``ssm.SLSTM_FP32``) stay fp32.  A model made
  ``trainable()`` stores fp32 masters, as the reference does, and every use
  site casts them to ``cfg.dtype``; its weights take gradients.
* Training (``loss``) runs each decoder layer, each xLSTM group and each
  cross-entropy chunk under ``torch.utils.checkpoint``, the reference's
  ``jax.checkpoint(nothing_saveable)``; ``forward``, ``prefill`` and
  ``decode_step`` run under ``no_grad`` and never checkpoint.
* The KV cache is (L, B, KV, S, dh) in ``cfg.dtype``, as the reference's;
  with ``kv_cache_int8`` it is int8 with fp32 ``k_scale``/``v_scale``
  (L, B, KV, S), and the decode kernel dequantizes in registers where the
  reference dequantizes the whole cache each step.  ``decode_step`` writes
  the new position of each row into it in place, at that row's
  ``lengths``, and the recurrent states (``ssm_h``/``ssm_conv``, ``slstm``,
  ``mlstm``) likewise; it returns the same tensors, the reference a new
  cache.
* The layer windows are a Python list (``_windows``), not a scanned array.
* ``decode_step``'s cross-attention runs the decode kernel
  (``kernels.ops.decode_attention`` at length F for every row, no window,
  no softcap), where the reference calls its non-causal
  ``flash_attention``: the same fp32 scores over the cached K/V.  The
  cache keeps the reference's (B, F, KV, dh) ``xk``/``xv``; each step
  makes one (B, KV, F, dh) copy of each, which every layer reads.
* A model cut over a model axis (``dist.tensor_parallel.shard_model``)
  serves through the same ``prefill`` and ``decode_step``: the units the
  axis splits run on the rank's blocks between ``_enter`` and ``_leave``,
  the others on gathered weights, as training runs them.  The KV cache
  stays whole on every rank (the reference's ``cache_sharding`` replicates
  it over ``model``): a split attention's new K/V are gathered over the
  heads and every rank writes every head, and the decode kernel reads the
  rank's heads of the cache in place (``kv0``).  Every rank must make the
  same calls with the same inputs: each step's collectives are the same on
  every rank and in the same order.
* ``input_specs`` returns ``FakeTensorMode`` tensors on the model's device
  (the dry-run's model is itself fake, on the CPU) in place of
  ``jax.ShapeDtypeStruct``: they hold no memory, and the kernel wrappers
  take their plain branch on them, so a traced step launches nothing.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, ShapeSpec
from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.ops import decode_attention
from . import ssm
from .layers import (
    attn_init,
    attn_out,
    attn_qkv,
    drop_log_paused,
    flash_attention,
    mlp,
    mlp_init,
    moe_ffn,
    moe_init,
    quantize_kv,
    rms_norm,
    softcap,
)

__all__ = ["Model", "DecoderLayer", "EncoderLayer", "XlstmGroup", "Params",
           "check_supported", "GLOBAL_WINDOW"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
GLOBAL_WINDOW = 2_000_000_000  # "window" value meaning full attention
CE_CHUNK = 512                 # positions per cross-entropy chunk, as the reference's


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration no family of the port takes."""
    if cfg.family not in ("dense", "moe", "hybrid", "ssm", "encdec", "vlm"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.family == "ssm" and cfg.n_layers % max(cfg.slstm_every, 1):
        raise ValueError(f"{cfg.name}: the ssm family needs n_layers % slstm_every == 0")


def _windows(cfg: ModelConfig, n_layers: int) -> List[int]:
    """Per-layer attention window (GLOBAL_WINDOW = full attention): gemma2's
    ``"local_global"`` pattern puts ``sliding_window`` on the even layers,
    hymba's ``"hymba"`` pattern on every layer outside ``global_layers``; a
    ``"global"`` pattern ignores ``sliding_window``, as the reference does."""
    if cfg.layer_pattern == "local_global":
        return [cfg.sliding_window if i % 2 == 0 else GLOBAL_WINDOW for i in range(n_layers)]
    if cfg.layer_pattern == "hymba":
        return [GLOBAL_WINDOW if i in cfg.global_layers else cfg.sliding_window
                for i in range(n_layers)]
    return [GLOBAL_WINDOW] * n_layers


def _zeros(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype), requires_grad=False)


class Params(nn.Module):
    """Named weights read as ``p[name]``, like the reference's dicts; a
    nested dict (the MoE layer's ``shared`` expert) is a submodule.  Names
    in ``fp32`` are stored in fp32 whatever ``dtype`` is; ``spec`` (name ->
    (shape, scale)) says how ``Model.init`` draws them."""

    def __init__(self, spec: Dict, device, dtype, fp32=()):
        super().__init__()
        self.spec = spec
        for name, (shape, _) in spec.items():
            self.register_parameter(
                name, _zeros(shape, device, torch.float32 if name in fp32 else dtype))

    def __getitem__(self, name: str):
        return getattr(self, name)


def _vector(d: int, device, dtype) -> nn.Parameter:
    return _zeros(d, device, dtype)


class _Unit(nn.Module):
    """A layer or group whose weights the model reads directly; training
    runs it through its module call (``unit(fn, *args)`` is ``fn(*args)``),
    so that hooks on the module see each use of its weights: FSDP2 gathers
    a sharded unit's weights there and reduce-scatters their grads."""

    def forward(self, fn, *args):
        return fn(*args)


class DecoderLayer(_Unit):
    """One decoder layer's weights: ``ln1``, ``ln2``, ``attn``, ``ffn`` (and
    ``ln1b``/``ln2b`` with post-norms).  An MoE layer's ``ffn`` holds the
    router and the experts' (E, ...) weights, and ``ffn.shared`` with a
    shared expert; a hybrid layer adds the Mamba head ``mamba``; an encdec
    layer the cross-attention's ``ln_x`` and ``xattn``."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _vector(d, device, dtype)
        self.ln2 = _vector(d, device, dtype)
        self.attn = Params(attn_init(cfg), device, dtype)
        if cfg.is_encdec:
            self.ln_x = _vector(d, device, dtype)
            self.xattn = Params(attn_init(cfg), device, dtype)
        if cfg.is_moe:
            self.ffn = Params(moe_init(cfg), device, dtype)
            if cfg.moe_shared_expert:
                self.ffn.shared = Params(mlp_init(d, cfg.d_ff), device, dtype)
        else:
            self.ffn = Params(mlp_init(d, cfg.d_ff), device, dtype)
        if cfg.family == "hybrid":
            self.mamba = Params(ssm.mamba_init(cfg), device, dtype, ssm.MAMBA_FP32)
        if cfg.post_norms:
            self.ln1b = _vector(d, device, dtype)
            self.ln2b = _vector(d, device, dtype)


class EncoderLayer(_Unit):
    """One encoder layer's weights: ``ln1``, ``ln2``, ``attn`` and a dense
    ``ffn`` (the reference inits it as a dense decoder layer, so it also
    has ``ln1b``/``ln2b`` with post-norms, which its forward never reads)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _vector(d, device, dtype)
        self.ln2 = _vector(d, device, dtype)
        self.attn = Params(attn_init(cfg), device, dtype)
        self.ffn = Params(mlp_init(d, cfg.d_ff), device, dtype)
        if cfg.post_norms:
            self.ln1b = _vector(d, device, dtype)
            self.ln2b = _vector(d, device, dtype)


class XlstmGroup(_Unit):
    """One xLSTM group: an sLSTM block (``slstm``, ``slstm_ln``) and
    ``slstm_every - 1`` mLSTM blocks (``mlstm.<j>``, and their norm scales
    stacked in ``mlstm_ln`` (every - 1, D), as the reference stacks them)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        every = max(cfg.slstm_every, 1)
        self.slstm = Params(ssm.slstm_init(cfg), device, dtype, ssm.SLSTM_FP32)
        self.slstm_ln = _vector(cfg.d_model, device, dtype)
        self.mlstm = nn.ModuleList(Params(ssm.mlstm_init(cfg), device, dtype)
                                   for _ in range(every - 1))
        self.mlstm_ln = _zeros((every - 1, cfg.d_model), device, dtype)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=DEFAULT_DEVICE):
        check_supported(cfg)
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]
        # the process group a data-parallel train step splits the batch over
        # (make_train_step sets it): the MoE layers average their routing
        # density over it
        self.data_group = None
        # the model axis a tensor-parallel train step cuts the weights over
        # (dist.tensor_parallel.shard_model sets it); None: every weight whole
        self.model_axis = None
        dev, dt = self.device, self.dtype
        # allocated as zeros here; init() draws the weights, or carry loads them
        self.embed = nn.Parameter(torch.zeros((cfg.vocab_size, cfg.d_model), device=dev, dtype=dt),
                                  requires_grad=False)
        self.final_ln = _vector(cfg.d_model, dev, dt)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.zeros((cfg.d_model, cfg.vocab_size), device=dev, dtype=dt),
                requires_grad=False)
        if cfg.family == "ssm":
            n_groups = cfg.n_layers // max(cfg.slstm_every, 1)
            self.blocks = nn.ModuleList(XlstmGroup(cfg, dev, dt) for _ in range(n_groups))
            self.windows: List[int] = []
        else:
            self.layers = nn.ModuleList(DecoderLayer(cfg, dev, dt) for _ in range(cfg.n_layers))
            self.windows = _windows(cfg, cfg.n_layers)
        if cfg.is_encdec:
            self.enc_layers = nn.ModuleList(EncoderLayer(cfg, dev, dt)
                                            for _ in range(cfg.n_enc_layers))
            self.enc_final_ln = _vector(cfg.d_model, dev, dt)

    @property
    def model_group(self):
        """The model axis's process group (None without one)."""
        return None if self.model_axis is None else self.model_axis.group

    def _split(self, unit: str) -> bool:
        """Whether ``unit`` ("attn", "mlp", "experts", "vocab") runs split
        over the model axis."""
        return self.model_axis is not None and self.model_axis.split[unit]

    def _w(self, pd: "Params"):
        """``pd``'s weights as this rank's compute reads them: ``pd``
        itself without a model axis; else each weight gathered, passed
        through or read as its block (``ModelAxis.weights``)."""
        return pd if self.model_axis is None else self.model_axis.weights(pd)

    def _attn_cfg(self) -> ModelConfig:
        """The config attention runs under: this rank's heads when it runs
        split over the model axis."""
        return self.cfg if self.model_axis is None else self.model_axis.attn_cfg

    def _enter(self, x: torch.Tensor, unit: str) -> torch.Tensor:
        """The input of ``unit``: through ``copy_to_model`` when it runs split."""
        return self.model_axis.enter(x) if self._split(unit) else x

    def _leave(self, y: torch.Tensor, unit: str) -> torch.Tensor:
        """The output of ``unit``: summed over the model axis when it runs split."""
        return self.model_axis.leave(y) if self._split(unit) else y

    def _kv_heads(self) -> Tuple[int, int]:
        """(kv0, KV_local): the heads of the whole cache this rank's
        attention reads (all of them without a model axis)."""
        if self.model_axis is None:
            return 0, self.cfg.n_kv_heads
        return self.model_axis.kv_heads

    def _cache_heads(self, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """K/V (B, S, KV_local, dh) of this rank's heads made whole for the
        cache, which every rank holds whole: stacked and gathered over the
        heads in one all-reduce when attention runs split, else as given."""
        if not self._split("attn"):
            return k, v
        return self.model_axis.gather(torch.stack((k, v)), 3).unbind(0)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights with the reference's shapes and scales: N(0, 1)
        drawn in fp32 one tensor at a time on the device, scaled, and cast
        into the stored type (at most one fp32 tensor exists at a time; the
        largest, qwen3-14b's embedding, is 3.1 GB).  Norm scales are zeros;
        Mamba's ``a_log``, ``d_skip`` and ``dt_bias`` take the reference's
        set values.  The draws come from ``generator``, not ``jax.random``:
        the tests carry the reference's weights instead (``carry``)."""
        cfg = self.cfg
        draws = [(self.embed, cfg.d_model ** -0.5)]
        if not cfg.tie_embeddings:
            draws.append((self.lm_head, cfg.d_model ** -0.5))
        for pd in self.modules():
            if isinstance(pd, Params):
                draws += [(pd[name], scale) for name, (_, scale) in pd.spec.items() if scale]
        for p in self.parameters():
            p.zero_()
        for p, scale in draws:
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                                dtype=torch.float32).mul_(scale))
        if cfg.family == "hybrid":
            const = ssm.mamba_constants(cfg, self.device)
            for layer in self.layers:
                for name, val in const.items():
                    layer.mamba[name].copy_(val)
        return self

    def trainable(self) -> "Model":
        """Make every weight an fp32 master that takes gradients, as the
        reference's parameters are: a bf16 model then computes in bf16 from
        casts made at each use, and its gradients come back in fp32.  A
        serving model keeps ``cfg.dtype`` storage and frozen weights.
        Returns ``self``.  Each weight is re-registered as a new fp32
        parameter (not swapped in place, which fake tensors refuse)."""
        for mod in self.modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                if p.dtype != torch.float32:
                    mod.register_parameter(name, nn.Parameter(p.detach().float()))
        self.requires_grad_(True)
        return self

    def _remat(self, fn, *args):
        """``fn(*args)``, under ``torch.utils.checkpoint`` when a graph is
        being built for the weights (its activations are recomputed in the
        backward pass, as the reference's ``jax.checkpoint``)."""
        if torch.is_grad_enabled() and self.embed.requires_grad:
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(), drop_log_paused()))
        return fn(*args)

    # ==================================================================
    # shared pieces
    # ==================================================================
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if self._split("vocab"):
            # this rank's rows of the vocab: the others' ids look up zeros,
            # and the sum over the model axis has every id's row
            local, inside = self.model_axis.vocab_mask(tokens)
            rows = torch.where(inside[..., None], self.embed[local],
                               torch.zeros((), dtype=self.embed.dtype, device=self.device))
            x = self.model_axis.leave(rows).to(self.dtype)
        else:
            x = self.embed[tokens].to(self.dtype)
        if self.cfg.embed_scale:
            x = x * torch.as_tensor(self.cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self._enter(rms_norm(x, self.final_ln, cfg.norm_eps), "vocab")
        logits = softcap((x @ self._head(x.dtype)).float(), cfg.final_softcap)
        if self._split("vocab"):
            logits = self.model_axis.gather(logits, logits.dim() - 1)
        return logits

    def _head(self, dtype: torch.dtype) -> torch.Tensor:
        """The (D, V) output projection in the compute type: the tied
        embedding's transpose or ``lm_head`` (this rank's vocab columns
        when the vocab runs split over the model axis)."""
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return head.to(dtype)

    def _attn_block(self, lp: DecoderLayer, x: torch.Tensor, window: int,
                    positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Self-attention sub-block with residual; also returns the layer's
        k and v (B, S, KV, dh) for the cache."""
        cfg, acfg = self.cfg, self._attn_cfg()
        p = self._w(lp.attn)
        h = self._enter(rms_norm(x, lp.ln1, cfg.norm_eps), "attn")
        q, k, v = attn_qkv(p, h, acfg, positions)
        o = attn_out(p, flash_attention(q, k, v, window, cfg.attn_softcap), acfg)
        o = self._leave(o, "attn")
        if cfg.post_norms:
            o = rms_norm(o, lp.ln1b, cfg.norm_eps)
        return x + o, k, v

    def _cross_block(self, lp: DecoderLayer, x: torch.Tensor, xk: torch.Tensor,
                     xv: torch.Tensor, length: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Cross-attention sub-block with residual: ``ln_x``, q = h @
        ``xattn.wq`` (no RoPE, no qk-norm), every encoder position, no
        window, no softcap, no post-norm.  Sequence form: xk/xv (B, F, KV,
        dh) through the non-causal ``flash_attention``.  Decode form (x
        (B, 1, D), ``length`` (B,) = F): xk/xv (B, KV, F, dh) through the
        decode kernel."""
        cfg = self._attn_cfg()
        p = self._w(lp.xattn)
        h = self._enter(rms_norm(x, lp.ln_x, cfg.norm_eps), "attn")
        b, s, _ = h.shape
        q = (h @ p["wq"].to(h.dtype)).reshape(
            b, s, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.dh)
        if length is None:
            o = flash_attention(q, xk, xv, causal=False)
        else:
            o = decode_attention(q[:, 0], xk, xv, length).to(x.dtype)[:, None]
        return x + self._leave(attn_out(p, o, cfg), "attn")

    def _cross_kv(self, lp0: DecoderLayer, enc_out: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The encoder output (B, F, D) under layer 0's ``xattn.wk`` and
        ``wv``: the cross-attention keys and values (B, F, KV * dh; this
        rank's KV groups when attention runs split)."""
        p = self._w(lp0.xattn)
        h = self._enter(enc_out, "attn")
        return h @ p["wk"].to(h.dtype), h @ p["wv"].to(h.dtype)

    def _encoder(self, frames) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bidirectional encoder over stub frame embeddings (B, F, D),
        and the cross K/V (B, F, KV, dh) of its output that every decoder
        layer attends to (the reference's backbone simplification), made
        in layer 0's module call so that a sharded layer 0 gathers its
        weights for it (the call returns no views: FSDP2 hooks its
        outputs)."""
        cfg = self.cfg
        x = torch.as_tensor(frames, device=self.device).to(self.dtype)
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        for lp in self.enc_layers:
            x = lp(self._remat, self._enc_layer, lp, x, positions)
        enc_out = rms_norm(x, self.enc_final_ln, cfg.norm_eps)
        lp0 = self.layers[0]
        shape = enc_out.shape[:2] + (self._attn_cfg().n_kv_heads, cfg.dh)
        return tuple(t.reshape(shape) for t in lp0(self._cross_kv, lp0, enc_out))

    def _enc_layer(self, lp: EncoderLayer, x: torch.Tensor, positions: torch.Tensor
                   ) -> torch.Tensor:
        """One encoder layer: non-causal self-attention (no window, no
        softcap, no post-norms) and the dense MLP, each with residual."""
        cfg, acfg = self.cfg, self._attn_cfg()
        p = self._w(lp.attn)
        h = self._enter(rms_norm(x, lp.ln1, cfg.norm_eps), "attn")
        q, k, v = attn_qkv(p, h, acfg, positions)
        x = x + self._leave(attn_out(p, flash_attention(q, k, v, causal=False), acfg), "attn")
        h = self._enter(rms_norm(x, lp.ln2, cfg.norm_eps), "mlp")
        return x + self._leave(mlp(self._w(lp.ffn), h), "mlp")

    def _mamba_block(self, lp: DecoderLayer, x: torch.Tensor, state=None):
        """A hybrid layer's Mamba head on the post-attention residual, which
        re-uses the layer's ``ln1``; returns (x + its output, its state)."""
        h = rms_norm(x, lp.ln1, self.cfg.norm_eps)
        m_out, st = ssm.mamba_seq(self._w(lp.mamba), h, self.cfg, state)
        return x + m_out, st

    def _ffn_block(self, lp: DecoderLayer, x: torch.Tensor, aux=0.0):
        """Feed-forward sub-block with residual; returns (x, aux + the MoE
        layer's load-balance loss)."""
        cfg = self.cfg
        h = rms_norm(x, lp.ln2, cfg.norm_eps)
        if cfg.is_moe:
            f, a = moe_ffn(self._w(lp.ffn), h, cfg, self.data_group, self.model_axis)
            aux = aux + a
        else:
            f = self._leave(mlp(self._w(lp.ffn), self._enter(h, "mlp")), "mlp")
        if cfg.post_norms:
            f = rms_norm(f, lp.ln2b, cfg.norm_eps)
        return x + f, aux

    def _xlstm(self, x: torch.Tensor, cache=None, step: bool = False) -> torch.Tensor:
        """The xLSTM groups over x (B, S, D).  Sequence forms from a zero
        state (``step`` False), their final states written into ``cache``
        when one is given; or one token (S = 1) through the step forms from
        ``cache``'s states, updated in place (``step`` True)."""
        for gi, grp in enumerate(self.blocks):
            if cache is None:
                x = grp(self._remat, self._xlstm_group, gi, grp, x)
            else:
                x = self._xlstm_group(gi, grp, x, cache, step)
        return x

    def _xlstm_group(self, gi: int, grp: XlstmGroup, x: torch.Tensor, cache=None,
                     step: bool = False) -> torch.Tensor:
        """One group of :meth:`_xlstm`: its sLSTM block, then its mLSTMs."""
        cfg = self.cfg
        blocks = [(ssm.slstm_seq, ssm.slstm_step, grp.slstm, grp.slstm_ln, "slstm", gi)]
        blocks += [(ssm.mlstm_seq, ssm.mlstm_step, mp, grp.mlstm_ln[j], "mlstm", (gi, j))
                   for j, mp in enumerate(grp.mlstm)]
        for seq_fn, step_fn, p, ln, key, at in blocks:
            h = rms_norm(x, ln, cfg.norm_eps)
            if step:
                st = {k: t[at] for k, t in cache[key].items()}
                y, new = step_fn(self._w(p), h[:, 0], cfg, st)
                y = y[:, None]
            else:
                y, new = seq_fn(self._w(p), h, cfg)
            if cache is not None:
                for k, t in cache[key].items():
                    t[at] = new[k]
            x = x + y
        return x

    def _decoder_forward(self, x: torch.Tensor, positions: torch.Tensor, xk=None, xv=None):
        """The decoder layers over embeddings x (B, S, D), cross-attending
        to ``xk``/``xv`` when given; returns (x, aux), aux the sum of the
        MoE layers' load-balance losses (0.0 otherwise)."""
        if self.cfg.family == "ssm":
            return self._xlstm(x), 0.0
        aux = 0.0
        for lp, w in zip(self.layers, self.windows):
            x, aux = lp(self._remat, self._layer, lp, w, x, aux, positions, xk, xv)
        return x, aux

    def _layer(self, lp: DecoderLayer, w: int, x: torch.Tensor, aux, positions: torch.Tensor,
               xk=None, xv=None):
        """One decoder layer of :meth:`_decoder_forward`: (x, aux) after it."""
        x, _, _ = self._attn_block(lp, x, w, positions)
        if self.cfg.family == "hybrid":
            x, _ = self._mamba_block(lp, x)
        if xk is not None:
            x = self._cross_block(lp, x, xk, xv)
        return self._ffn_block(lp, x, aux)

    # ==================================================================
    # public: forward / loss
    # ==================================================================
    def _prompt(self, batch: Dict) -> Tuple[torch.Tensor, int, Tuple]:
        """The decoder's input of a batch: (embeddings (B, P + S, D) with a
        vlm model's patches (B, P, D) in front, P (0 but for vlm), the cross
        K/V of an encdec model's encoder over ``batch["frames"]``, else
        ``(None, None)``)."""
        x = self._embed(self._tokens(batch["tokens"]))
        n_prefix = 0
        if self.cfg.family == "vlm":
            patches = torch.as_tensor(batch["patches"], device=self.device).to(x.dtype)
            x = torch.cat([patches, x], dim=1)
            n_prefix = patches.shape[1]
        kv = self._encoder(batch["frames"]) if self.cfg.is_encdec else (None, None)
        return x, n_prefix, kv

    def _hidden(self, batch: Dict) -> Tuple[torch.Tensor, Union[float, torch.Tensor]]:
        """Final hidden states over the token positions (pre-logits; a vlm
        model's prefix cut off); under autograd when the caller's grad mode
        is on."""
        x, n_prefix, kv = self._prompt(batch)
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        x, aux = self._decoder_forward(x, positions, *kv)
        return x[:, n_prefix:], aux

    @torch.no_grad()
    def forward(self, batch: Dict) -> Tuple[torch.Tensor, Union[float, torch.Tensor]]:
        """Teacher-forced logits over the token positions.  Returns
        (logits (B,S,V) fp32, aux_loss): 0.0 without MoE, a 0-d fp32 tensor
        with MoE."""
        x, aux = self._hidden(batch)
        return self._logits(x), aux

    def loss(self, batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Chunked cross-entropy, as the reference's ``loss``: the (B, S, V)
        fp32 logits never exist at once.  The positions run in chunks of
        min(CE_CHUNK, S), the last padded with labels -1; each chunk's
        logits get ``final_softcap`` before the log-sum-exp, labels < 0
        count nothing, and each chunk is recomputed in the backward pass
        (``torch.utils.checkpoint``), so one chunk's fp32 logits live at a
        time.  Returns (ce + 0.01 * aux, {"ce", "aux", "tokens"}): 0-d
        tensors (aux a float 0.0 without MoE)."""
        cfg = self.cfg
        x, aux = self._hidden(batch)
        labels = self._tokens(batch["labels"])
        x = self._enter(rms_norm(x, self.final_ln, cfg.norm_eps), "vocab")
        head = self._head(x.dtype)
        s = x.shape[1]
        ch = min(CE_CHUNK, s)
        pad = (-s) % ch
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=-1)
        ce_sum = torch.zeros((), device=self.device)
        for c0 in range(0, s + pad, ch):
            ce_sum = ce_sum + self._remat(self._chunk_ce, x[:, c0:c0 + ch],
                                          labels[:, c0:c0 + ch], head)
        n_tok = torch.clamp_min((labels >= 0).sum(), 1)
        ce = ce_sum / n_tok
        return ce + 0.01 * aux, {"ce": ce, "aux": aux, "tokens": n_tok}

    def _chunk_ce(self, xc: torch.Tensor, lc: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        """Summed cross-entropy of one chunk (B, ch, D) against labels
        (B, ch), in fp32.  With the vocab split over the model axis each
        rank holds its columns' logits only: the max, the sum of
        exponentials and the label's logit are each reduced over the axis."""
        logits = softcap((xc @ head).float(), self.cfg.final_softcap)
        valid = lc >= 0
        if self._split("vocab"):
            axis = self.model_axis
            m = axis.max(logits.amax(-1))
            lse = m + torch.log(axis.leave(torch.exp(logits - m[..., None]).sum(-1)))
            local, inside = axis.vocab_mask(torch.clamp_min(lc, 0))
            ll = torch.gather(logits, -1, local[..., None])[..., 0]
            ll = axis.leave(torch.where(inside, ll, torch.zeros((), device=ll.device)))
            return torch.where(valid, lse - ll, torch.zeros((), device=lse.device)).sum()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, torch.clamp_min(lc, 0)[..., None])[..., 0]
        return torch.where(valid, lse - ll, torch.zeros((), device=lse.device)).sum()

    # ==================================================================
    # serving: cache init / prefill / decode
    # ==================================================================
    def init_cache(self, b: int, max_len: int) -> Dict:
        """The reference's cache layout: K/V (L, B, KV, S, dh) in
        ``cfg.dtype``, or int8 with fp32 ``k_scale``/``v_scale`` (L, B, KV,
        S); a hybrid model's Mamba states ``ssm_h`` (L, B, Di, N) and
        ``ssm_conv`` (L, B, K-1, Di); an xLSTM's ``slstm`` (G, B, H, dh) and
        ``mlstm`` (G, every-1, B, ...) state dicts, each ``m`` at -1e30; an
        encdec model's cross K/V ``xk``/``xv`` (B, F, KV, dh) in
        ``cfg.dtype``, never int8.  Recurrent states are fp32."""
        cfg = self.cfg
        dev = self.device
        f32 = dict(device=dev, dtype=torch.float32)
        cache: Dict = {}
        if cfg.family != "ssm":
            shape = (cfg.n_layers, b, cfg.n_kv_heads, max_len, cfg.dh)
            cdt = torch.int8 if cfg.kv_cache_int8 else self.dtype
            cache["k"] = torch.zeros(shape, device=dev, dtype=cdt)
            cache["v"] = torch.zeros(shape, device=dev, dtype=cdt)
            if cfg.kv_cache_int8:
                # per-(position, head) scales: 4 / dh bytes a cached byte
                cache["k_scale"] = torch.zeros(shape[:-1], **f32)
                cache["v_scale"] = torch.zeros(shape[:-1], **f32)
        if cfg.family == "hybrid":
            st = ssm.mamba_state(b, cfg, dev)
            cache["ssm_h"] = torch.zeros((cfg.n_layers,) + st["h"].shape, **f32)
            cache["ssm_conv"] = torch.zeros((cfg.n_layers,) + st["conv"].shape, **f32)
        if cfg.family == "ssm":
            g, every = len(self.blocks), max(cfg.slstm_every, 1)
            cache["slstm"] = {k: t.expand((g,) + t.shape).contiguous()
                              for k, t in ssm.slstm_state(b, cfg, dev).items()}
            cache["mlstm"] = {k: t.expand((g, every - 1) + t.shape).contiguous()
                              for k, t in ssm.mlstm_state(b, cfg, dev).items()}
        if cfg.is_encdec:
            shape = (b, cfg.frontend_len, cfg.n_kv_heads, cfg.dh)
            cache["xk"] = torch.zeros(shape, device=dev, dtype=self.dtype)
            cache["xv"] = torch.zeros(shape, device=dev, dtype=self.dtype)
        return cache

    @property
    def supports_ragged_prefill(self) -> bool:
        """Whether unequal-length prompt batching is exact (the reference's
        flag).  Attention families: causal masking isolates each row's last
        real position from its pad tail.  With MoE, as in the reference, the
        batch's padded length sets each row's expert capacity, so a row may
        drop other tokens in a batch than alone unless the capacity factor
        leaves room for all.  Recurrent families (ssm, hybrid) fold pad
        steps into their carried state: ``ServeEngine`` serves them
        equal-length batches only."""
        return self.cfg.family not in ("ssm", "hybrid")

    @staticmethod
    def _last_hidden(x: torch.Tensor, lengths: Optional[torch.Tensor],
                     n_prefix: int = 0) -> torch.Tensor:
        """Hidden state at each row's LAST REAL position (``n_prefix +
        lengths - 1``, past a vlm model's prefix); ``lengths=None`` takes
        the last column."""
        if lengths is None:
            return x[:, -1:, :]
        pos = n_prefix + torch.clamp_min(lengths.to(x.device).long(), 1) - 1
        return x[torch.arange(x.shape[0], device=x.device), pos][:, None, :]

    @torch.no_grad()
    def prefill(self, batch: Dict, max_len: int, lengths=None) -> Tuple[torch.Tensor, Dict]:
        """Run the prompt through the model, returning (last-token logits
        (B, V) fp32, populated cache).  With ``lengths`` (B,) each row's
        logits come from its own last position (past a vlm model's prefix);
        K/V of a short row's pad tail are written too, beyond the length
        mask decode applies.  With the int8 cache each layer's K/V are
        quantised into it, while the layer's own attention runs on the
        unquantised K/V, as the reference's.  A vlm model's prefix takes
        the cache's first P positions; an encdec model's encoder output
        fills the cross cache.  On a model cut over a model axis each
        split attention's K/V (and the cross K/V) are gathered over the
        heads, and every rank fills the whole cache."""
        cfg = self.cfg
        x, n_prefix, (xk, xv) = self._prompt(batch)
        b, s = x.shape[:2]
        if s > max_len:
            raise ValueError(f"prompt length {s} exceeds the cache's max_len {max_len}")
        cache = self.init_cache(b, max_len)
        if xk is not None:
            cache["xk"], cache["xv"] = self._cache_heads(xk, xv)
        if cfg.family == "ssm":
            x = self._xlstm(x, cache)
        else:
            positions = torch.arange(s, device=self.device)[None, :]
            for i, (lp, w) in enumerate(zip(self.layers, self.windows)):
                x, k, v = self._attn_block(lp, x, w, positions)
                for name, t in zip(("k", "v"), self._cache_heads(k, v)):
                    t = t.transpose(1, 2)                   # (B, KV, S, dh)
                    if cfg.kv_cache_int8:
                        t, scale = quantize_kv(t)
                        cache[f"{name}_scale"][i, :, :, :s] = scale
                    cache[name][i, :, :, :s] = t
                if cfg.family == "hybrid":
                    x, st = self._mamba_block(lp, x)
                    cache["ssm_h"][i], cache["ssm_conv"][i] = st["h"], st["conv"]
                if xk is not None:
                    x = self._cross_block(lp, x, xk, xv)
                x, _ = self._ffn_block(lp, x)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=self.device)
        return self._logits(self._last_hidden(x, lengths, n_prefix))[:, 0], cache

    @torch.no_grad()
    def decode_step(self, cache: Dict, tokens, lengths) -> Tuple[torch.Tensor, Dict]:
        """One decode step.  tokens: (B,); lengths: (B,) current cache fill
        (the new token's k/v are written at ``lengths``, so every
        ``lengths[b]`` must be < the cache's max_len; a vlm model's count
        its prefix).  An encdec model's layers then cross-attend to the
        whole cross cache through the decode kernel, over one (B, KV, F, dh)
        copy of ``xk`` and of ``xv`` that every layer reads.  On a model cut
        over a model axis where attention runs split, each rank computes q,
        k and v of its own KV groups, writes the gathered k and v into every
        head of its whole cache, and the kernel reads its heads of the cache
        in place (``kv0``); the cross copies take its heads only.  Returns
        (logits (B,V) fp32, the cache, updated in place)."""
        cfg, acfg = self.cfg, self._attn_cfg()
        tokens = self._tokens(tokens)
        lengths = torch.as_tensor(lengths, device=self.device).long()
        x = self._embed(tokens[:, None])                    # (B, 1, D)
        if cfg.family == "ssm":
            return self._logits(self._xlstm(x, cache, step=True))[:, 0], cache
        b = tokens.shape[0]
        kv0, kvl = self._kv_heads()
        g, dh = acfg.n_heads // acfg.n_kv_heads, cfg.dh
        rows = torch.arange(b, device=self.device)
        positions = lengths[:, None]
        int8 = cfg.kv_cache_int8
        if cfg.is_encdec:
            xk, xv = (cache[n][:, :, kv0:kv0 + kvl].transpose(1, 2).contiguous()
                      for n in ("xk", "xv"))
            x_len = torch.full((b,), cfg.frontend_len, device=self.device, dtype=torch.int32)
        for i, (lp, w) in enumerate(zip(self.layers, self.windows)):
            p = self._w(lp.attn)
            h = self._enter(rms_norm(x, lp.ln1, cfg.norm_eps), "attn")
            q, k, v = attn_qkv(p, h, acfg, positions)
            k, v = self._cache_heads(k, v)                  # (B, 1, KV, dh): every head
            kc, vc = cache["k"][i], cache["v"][i]           # (B, KV, S, dh) views
            scales = {}
            if int8:
                scales = dict(k_scale=cache["k_scale"][i], v_scale=cache["v_scale"][i],
                              dequant_dtype=x.dtype)
                (kq, ks), (vq, vs) = quantize_kv(k[:, 0]), quantize_kv(v[:, 0])
                scales["k_scale"][rows, :, lengths] = ks
                scales["v_scale"][rows, :, lengths] = vs
                k, v = kq[:, None], vq[:, None]
            # advanced indices around a slice: the indexed view is (B, KV, dh)
            kc[rows, :, lengths, :] = k[:, 0]
            vc[rows, :, lengths, :] = v[:, 0]
            # f32 out of the kernel, back to the compute type as the
            # reference's decode_attention_xla returns q's type
            o = decode_attention(q[:, 0], kc, vc, lengths + 1, window=w,
                                 attn_softcap=cfg.attn_softcap, kv0=kv0, **scales).to(x.dtype)
            o = self._leave(attn_out(p, o.reshape(b, 1, kvl, g, dh), acfg), "attn")
            if cfg.post_norms:
                o = rms_norm(o, lp.ln1b, cfg.norm_eps)
            x = x + o
            if cfg.family == "hybrid":
                st = {"h": cache["ssm_h"][i], "conv": cache["ssm_conv"][i]}
                x, st = self._mamba_block(lp, x, st)
                cache["ssm_h"][i], cache["ssm_conv"][i] = st["h"], st["conv"]
            if cfg.is_encdec:
                x = self._cross_block(lp, x, xk, xv, x_len)
            x, _ = self._ffn_block(lp, x)
        return self._logits(x)[:, 0], cache

    # ==================================================================
    # input specs for the dry-run (no allocation)
    # ==================================================================
    def input_specs(self, shape: ShapeSpec, mode=None) -> Dict:
        """Stand-ins for every input of the step function of this shape
        cell, as the reference's: train -> {"batch": tokens, labels};
        prefill -> {"batch": tokens}; a vlm batch adds ``patches`` and an
        encdec batch ``frames`` (B, frontend_len, D) in ``cfg.dtype``;
        decode -> {"cache", "tokens", "lengths"} (one token against a cache
        of ``seq_len`` positions, from ``init_cache``).  Tokens and lengths
        are int32.  The tensors are fake (``FakeTensorMode``; ``mode``, else
        the mode of the model's own fake weights, else a new one) on the
        model's device."""
        from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

        if mode is None:
            mode = self.embed.fake_mode if isinstance(self.embed, FakeTensor) else FakeTensorMode()
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32 = dict(dtype=torch.int32, device=self.device)
        front = {"vlm": "patches", "encdec": "frames"}.get(cfg.family)
        with mode:
            if shape.kind in ("train", "prefill"):
                batch = {"tokens": torch.empty((b, s), **i32)}
                if shape.kind == "train":
                    batch["labels"] = torch.empty((b, s), **i32)
                if front:
                    batch[front] = torch.empty((b, cfg.frontend_len, cfg.d_model),
                                               dtype=self.dtype, device=self.device)
                return {"batch": batch}
            return {"cache": self.init_cache(b, s), "tokens": torch.empty((b,), **i32),
                    "lengths": torch.empty((b,), **i32)}

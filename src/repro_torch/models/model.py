"""The serving language model, dense family, as an ``nn.Module``.

Port of ``repro/models/model.py`` for ``family="dense"`` with full
attention (qwen3-14b):

    model = Model(cfg, device="cuda").init(torch.Generator("cuda").manual_seed(0))
    logits, aux = model.forward({"tokens": tokens})
    logits, cache = model.prefill({"tokens": tokens}, max_len, lengths=lengths)
    logits, cache = model.decode_step(cache, next_tokens, lengths)

Parameters keep the reference's names and shapes, one module per layer
(``layers.<i>.attn.wq`` is row i of the reference's stacked
``params["layers"]["attn"]["wq"]``), and the layer scan is a Python loop.

Differences from the reference, each giving the same numbers:

* Weights are stored in ``cfg.dtype`` on the device.  The reference keeps
  fp32 masters and casts them to ``cfg.dtype`` before every use (its
  ``_embed``, ``_logits``, ``attn_qkv``, ``attn_out``, ``mlp``, ``rms_norm``),
  so storing the cast values gives the same products at half the memory in
  bf16.
* The KV cache is (L, B, KV, S, dh) in ``cfg.dtype``, as the reference's.
  ``decode_step`` writes the new position of each row into it in place, at
  that row's ``lengths``, and returns the same tensors; the reference
  returns a new cache.

Configurations that need what this slice has not ported raise
``NotImplementedError`` at construction, never mis-serve: other families,
MoE, attention softcap, sliding windows, the int8 KV cache.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.ops import decode_attention
from .layers import (
    attn_init,
    attn_out,
    attn_qkv,
    flash_attention,
    mlp,
    mlp_init,
    rms_norm,
    softcap,
)

__all__ = ["Model", "DenseLayer", "check_supported"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_LATER = "ROADMAP Queue 1 item 13"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot serve yet."""
    missing = []
    if cfg.family != "dense":
        missing.append(f"family {cfg.family!r}")
    if cfg.is_moe:
        missing.append("MoE feed-forward (moe_ffn)")
    if cfg.attn_softcap > 0:
        missing.append("attention softcap")
    if cfg.layer_pattern != "global" or cfg.sliding_window > 0:
        missing.append("sliding-window attention")
    if cfg.kv_cache_int8:
        missing.append("the int8 KV cache")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch yet ({_LATER})")


def _params(spec: Dict, device, dtype) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.zeros(shape, device=device, dtype=dtype), requires_grad=False)
        for name, (shape, _) in spec.items()})


def _vector(d: int, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, device=device, dtype=dtype), requires_grad=False)


class DenseLayer(nn.Module):
    """One decoder layer's weights: ``ln1``, ``ln2``, ``attn``, ``ffn`` (and
    ``ln1b``/``ln2b`` with post-norms)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _vector(d, device, dtype)
        self.ln2 = _vector(d, device, dtype)
        self.attn = _params(attn_init(cfg), device, dtype)
        self.ffn = _params(mlp_init(d, cfg.d_ff), device, dtype)
        if cfg.post_norms:
            self.ln1b = _vector(d, device, dtype)
            self.ln2b = _vector(d, device, dtype)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=DEFAULT_DEVICE):
        check_supported(cfg)
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]
        dev, dt = self.device, self.dtype
        # allocated as zeros here; init() draws the weights, or carry loads them
        self.embed = nn.Parameter(torch.zeros((cfg.vocab_size, cfg.d_model), device=dev, dtype=dt),
                                  requires_grad=False)
        self.final_ln = _vector(cfg.d_model, dev, dt)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.zeros((cfg.d_model, cfg.vocab_size), device=dev, dtype=dt),
                requires_grad=False)
        self.layers = nn.ModuleList(DenseLayer(cfg, dev, dt) for _ in range(cfg.n_layers))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights with the reference's shapes and scales: N(0, 1)
        drawn in fp32 one tensor at a time on the device, scaled, and cast
        into the stored type (at most one fp32 tensor exists at a time; the
        largest, qwen3-14b's embedding, is 3.1 GB).  Norm scales are zeros.
        The draws come from ``generator``, not ``jax.random``: the tests
        carry the reference's weights instead (``carry``)."""
        cfg = self.cfg
        draws = [(self.embed, cfg.d_model ** -0.5)]
        if not cfg.tie_embeddings:
            draws.append((self.lm_head, cfg.d_model ** -0.5))
        for layer in self.layers:
            for pd, spec in ((layer.attn, attn_init(cfg)), (layer.ffn, mlp_init(cfg.d_model, cfg.d_ff))):
                draws += [(pd[name], scale) for name, (_, scale) in spec.items() if scale]
        for p in self.parameters():
            p.zero_()
        for p, scale in draws:
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                                dtype=torch.float32).mul_(scale))
        return self

    # ==================================================================
    # shared pieces
    # ==================================================================
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.embed_scale:
            x = x * torch.as_tensor(self.cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        return softcap((x @ head).float(), cfg.final_softcap)

    def _attn_block(self, lp: DenseLayer, x: torch.Tensor, positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Self-attention sub-block with residual; also returns the layer's
        k and v (B, S, KV, dh) for the cache."""
        cfg = self.cfg
        h = rms_norm(x, lp.ln1, cfg.norm_eps)
        q, k, v = attn_qkv(lp.attn, h, cfg, positions)
        o = attn_out(lp.attn, flash_attention(q, k, v), cfg)
        if cfg.post_norms:
            o = rms_norm(o, lp.ln1b, cfg.norm_eps)
        return x + o, k, v

    def _ffn_block(self, lp: DenseLayer, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        f = mlp(lp.ffn, rms_norm(x, lp.ln2, cfg.norm_eps))
        if cfg.post_norms:
            f = rms_norm(f, lp.ln2b, cfg.norm_eps)
        return x + f

    def _decoder_forward(self, x: torch.Tensor, positions: torch.Tensor):
        """The decoder layers over embeddings x (B, S, D); returns (x, aux)
        with aux = 0.0 (the dense family has no auxiliary loss)."""
        for lp in self.layers:
            x, _, _ = self._attn_block(lp, x, positions)
            x = self._ffn_block(lp, x)
        return x, 0.0

    # ==================================================================
    # public: forward
    # ==================================================================
    @torch.no_grad()
    def _hidden(self, batch: Dict) -> Tuple[torch.Tensor, float]:
        """Final hidden states over the token positions (pre-logits)."""
        x = self._embed(self._tokens(batch["tokens"]))
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        return self._decoder_forward(x, positions)

    @torch.no_grad()
    def forward(self, batch: Dict) -> Tuple[torch.Tensor, float]:
        """Teacher-forced logits over the token positions.  Returns
        (logits (B,S,V) fp32, aux_loss)."""
        x, aux = self._hidden(batch)
        return self._logits(x), aux

    # ==================================================================
    # serving: cache init / prefill / decode
    # ==================================================================
    def init_cache(self, b: int, max_len: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        shape = (cfg.n_layers, b, cfg.n_kv_heads, max_len, cfg.dh)
        return {"k": torch.zeros(shape, device=self.device, dtype=self.dtype),
                "v": torch.zeros(shape, device=self.device, dtype=self.dtype)}

    @property
    def supports_ragged_prefill(self) -> bool:
        """Unequal-length prompt batching is exact for attention families:
        causal masking isolates each row's last real position from its pad
        tail (the reference's flag; every family the port serves has it)."""
        return self.cfg.family not in ("ssm", "hybrid")

    @staticmethod
    def _last_hidden(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        """Hidden state at each row's LAST REAL position (``lengths - 1``);
        ``lengths=None`` takes the last column."""
        if lengths is None:
            return x[:, -1:, :]
        pos = torch.clamp_min(lengths.to(x.device).long(), 1) - 1
        return x[torch.arange(x.shape[0], device=x.device), pos][:, None, :]

    @torch.no_grad()
    def prefill(self, batch: Dict, max_len: int, lengths=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Run the prompt through the model, returning (last-token logits
        (B, V) fp32, populated cache).  With ``lengths`` (B,) each row's
        logits come from its own last position; K/V of a short row's pad
        tail are written too, beyond the length mask decode applies."""
        tokens = self._tokens(batch["tokens"])
        b, s = tokens.shape
        if s > max_len:
            raise ValueError(f"prompt length {s} exceeds the cache's max_len {max_len}")
        cache = self.init_cache(b, max_len)
        x = self._embed(tokens)
        positions = torch.arange(s, device=self.device)[None, :]
        for i, lp in enumerate(self.layers):
            x, k, v = self._attn_block(lp, x, positions)
            cache["k"][i, :, :, :s] = k.transpose(1, 2)     # (B, KV, S, dh)
            cache["v"][i, :, :, :s] = v.transpose(1, 2)
            x = self._ffn_block(lp, x)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=self.device)
        return self._logits(self._last_hidden(x, lengths))[:, 0], cache

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor], tokens, lengths
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One decode step.  tokens: (B,); lengths: (B,) current cache fill
        (the new token's k/v are written at ``lengths``, so every
        ``lengths[b]`` must be < the cache's max_len).  Returns (logits (B,V)
        fp32, the cache, updated in place)."""
        cfg = self.cfg
        tokens = self._tokens(tokens)
        lengths = torch.as_tensor(lengths, device=self.device).long()
        b = tokens.shape[0]
        kvh, g, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.dh
        rows = torch.arange(b, device=self.device)
        x = self._embed(tokens[:, None])                    # (B, 1, D)
        positions = lengths[:, None]
        for i, lp in enumerate(self.layers):
            h = rms_norm(x, lp.ln1, cfg.norm_eps)
            q, k, v = attn_qkv(lp.attn, h, cfg, positions)
            kc, vc = cache["k"][i], cache["v"][i]           # (B, KV, S, dh) views
            # advanced indices around a slice: the indexed view is (B, KV, dh)
            kc[rows, :, lengths, :] = k[:, 0]
            vc[rows, :, lengths, :] = v[:, 0]
            # f32 out of the kernel, back to the compute type as the
            # reference's decode_attention_xla returns q's type
            o = decode_attention(q[:, 0], kc, vc, lengths + 1).to(x.dtype)
            o = attn_out(lp.attn, o.reshape(b, 1, kvh, g, dh), cfg)
            if cfg.post_norms:
                o = rms_norm(o, lp.ln1b, cfg.norm_eps)
            x = self._ffn_block(lp, x + o)
        return self._logits(x)[:, 0], cache

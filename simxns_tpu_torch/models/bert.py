"""BERT-family encoder in PyTorch (port of ``simxns_tpu/models/bert.py``).

Post-LN layers in the HF BERT layout, with the JAX package's numerics:
bf16 activations over f32 parameters (flax ``Dense(dtype=bf16)`` casts
operands to bf16, accumulates in f32, rounds, then adds the bf16 bias;
``Embed(dtype=bf16)`` casts each table to bf16 before the sum;
``LayerNorm(dtype=bf16)`` takes its statistics in f32 as
``E[x^2] - E[x]^2``).

On the card the bf16 products run as bf16 GEMMs with f32 accumulation
(the flax contract; ``resolve_device`` turns off cuBLAS's reduced-precision
split-K reduction); on the CPU the operands are upcast and the result
rounded, which gives the same values.

The default impls are plain autograd and train (the attention kernels
K5/K6 and K7/K8 have their own backward, ``ops/flash_attention.py``).
``ffn_impl="fused_vjp"`` trains through the fused FFN kernels K9-K11 and
``ffn_impl="fused"`` encodes through K12 (``ops/fused_ffn.py``);
``ffn_impl="int8"`` and ``proj_impl="int8"`` encode through K14 and K13
(q, k and v as one call), over the layer's cached int8 weights; the
parameters are the same under every knob. ``remat=True`` recomputes each
layer in the backward pass (``torch.utils.checkpoint``, per layer, as the
JAX ``run_layers``); ``remat_policy="dots"`` is not ported.
``layer_impl="fused_int8"`` runs each layer on the Hopper kernels of
:mod:`simxns_tpu_torch.ops.fused_layer` (encode only, under
``torch.no_grad()``); its int8 weights, and those of the two int8 knobs,
are cached per layer and quantized again whenever a parameter changes, so
an encode-only view that shares a training model's ``Parameter`` objects
(:func:`share_parameters`, the ``int8_view`` of either model) follows
every optimizer update. Not ported yet: dropout, the MLM head. Parameter
names follow the JAX tree (``layers.{i}`` for ``layer_{i}``);
:func:`simxns_tpu_torch.models.convert.params_from_jax` maps a flax tree
onto them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from simxns_tpu_torch.ops import fused_ffn
from simxns_tpu_torch.ops.attention import multi_head_attention
from simxns_tpu_torch.ops.fused_layer import (QuantizedLayer,
                                              fused_encoder_layer_int8,
                                              quantize_layer)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2           # 0 = no token-type embeddings
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    position_style: str = "bert"       # "roberta": positions from non-pad
    pad_token_id: int = 0              # tokens + pad offset
    embedding_size: Optional[int] = None  # ELECTRA factorized embeddings
    dtype: torch.dtype = torch.bfloat16   # activation dtype
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "flash"
    small_s_attn: Optional[str] = None
    ffn_impl: str = "xla"
    proj_impl: str = "xla"
    layer_impl: str = "xla"
    gelu: str = "exact"
    remat: bool = False                   # recompute each layer in backward
    remat_policy: Optional[str] = None    # None = recompute everything

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        """A 2-layer config for tests."""
        base = dict(vocab_size=1024, hidden_size=64, num_layers=2,
                    num_heads=4, intermediate_size=128,
                    max_position_embeddings=128, dtype=torch.float32)
        base.update(kw)
        return BertConfig(**base)

    def replace(self, **kw) -> "BertConfig":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if self.gelu not in ("exact", "tanh"):
            raise ValueError(f"BertConfig.gelu must be 'exact' or 'tanh', "
                             f"got {self.gelu!r}")
        if self.position_style not in ("bert", "roberta"):
            raise ValueError(f"BertConfig.position_style must be 'bert' or "
                             f"'roberta', got {self.position_style!r}")
        for field, allowed in (
                ("attention_impl", ("xla", "flash")),
                ("small_s_attn", (None, "xla", "group")),
                ("ffn_impl", ("xla", "fused", "fused_vjp", "int8")),
                ("proj_impl", ("xla", "int8")),
                ("layer_impl", ("xla", "fused_int8"))):
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(f"BertConfig.{field} must be one of "
                                 f"{allowed}, got {v!r}")
        # the fused kernels compute exact (erf) GELU; refuse a config that
        # asks them for another activation than the weights were trained on
        if self.gelu == "tanh" and (
                self.ffn_impl != "xla" or self.layer_impl != "xla"):
            raise ValueError(
                "gelu='tanh' is only implemented by the XLA composition; "
                f"ffn_impl={self.ffn_impl!r}/layer_impl={self.layer_impl!r} "
                "hardcode exact erf GELU — use gelu='exact' with fused "
                "kernels, or the XLA path with tanh")


@dataclasses.dataclass
class EncoderOutput:
    last_hidden_state: torch.Tensor                 # [B, S, H]
    pooled: torch.Tensor                            # [B, H] == CLS token
    hidden_states: Optional[List[torch.Tensor]] = None


def _guard_quantized_under_grad(module: nn.Module, x: torch.Tensor,
                                impl: str) -> None:
    """Refuse to record autograd through an encode-only quantized path:
    ``round()`` has zero gradient and the kernels record none, so a
    backward through it would silently train nothing."""
    if torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad
                                   for p in module.parameters())):
        raise ValueError(
            f"BertConfig {impl} is an encode-only quantized path but autograd "
            "is recording: run it under torch.no_grad() or "
            "torch.inference_mode(), and train with the default "
            "(differentiable) impls — the parameters interchange")


def dense(layer: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dt)``: operands cast to ``dt``, f32 accumulation,
    result rounded to ``dt``, then the ``dt`` bias added."""
    return fused_ffn.linear_dt(x, layer.weight, layer.bias, dt)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dt: torch.dtype,
               eps: float) -> torch.Tensor:
    """flax ``LayerNorm(dtype=dt)``: f32 statistics (fast variance
    ``E[x^2] - E[x]^2``, clipped at 0), result cast to ``dt``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          0.0)
    mul = torch.rsqrt(var + eps) * ln.weight.float()
    return ((xf - mean) * mul + ln.bias.float()).to(dt)


def _linear(i: int, o: int, cfg: BertConfig) -> nn.Linear:
    return nn.Linear(i, o, dtype=cfg.param_dtype)


def _ln(width: int, cfg: BertConfig) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=cfg.layer_norm_eps, dtype=cfg.param_dtype)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        width = cfg.embedding_size or cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, width,
                                            dtype=cfg.param_dtype)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                width, dtype=cfg.param_dtype)
        if cfg.type_vocab_size > 0:
            self.token_type_embeddings = nn.Embedding(
                cfg.type_vocab_size, width, dtype=cfg.param_dtype)
        self.layer_norm = _ln(width, cfg)
        if width != cfg.hidden_size:
            self.embeddings_project = _linear(width, cfg.hidden_size, cfg)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        b, s = input_ids.shape
        if position_ids is None:
            if cfg.position_style == "roberta":
                not_pad = (input_ids != cfg.pad_token_id).long()
                position_ids = torch.cumsum(not_pad, dim=1) * not_pad \
                    + cfg.pad_token_id
            else:
                position_ids = torch.arange(
                    s, device=input_ids.device).expand(b, s)
        x = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(position_ids).to(dt))
        if cfg.type_vocab_size > 0:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.token_type_embeddings(token_type_ids).to(dt)
        x = layer_norm(self.layer_norm, x, dt, cfg.layer_norm_eps)
        if hasattr(self, "embeddings_project"):
            x = dense(self.embeddings_project, x, dt)
        return x


class BertSelfAttention(nn.Module):
    """q/k/v projections, attention, output projection, residual + LN."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = _linear(h, h, cfg)
        self.key = _linear(h, h, cfg)
        self.value = _linear(h, h, cfg)
        self.output = _linear(h, h, cfg)
        self.output_layer_norm = _ln(h, cfg)

    def forward(self, hidden: torch.Tensor,
                attention_mask: Optional[torch.Tensor],
                quantized: Optional[QuantizedLayer] = None) -> torch.Tensor:
        """``quantized``: the layer's int8 weights (:meth:`BertLayer.
        quantized`), which ``proj_impl="int8"`` runs on."""
        cfg, dt = self.cfg, self.cfg.dtype
        b, s, h = hidden.shape
        d = h // cfg.num_heads

        def split(x):
            return x.reshape(b, s, cfg.num_heads, d).transpose(1, 2)

        if cfg.proj_impl == "int8":
            _guard_quantized_under_grad(self, hidden, "proj_impl='int8'")
            q, k, v = self._int8_qkv(hidden.to(dt), quantized)
        else:
            q, k, v = (dense(m, hidden, dt)
                       for m in (self.query, self.key, self.value))
        ctx, _ = multi_head_attention(split(q), split(k), split(v),
                                      attention_mask,
                                      impl=cfg.attention_impl,
                                      small_s_impl=cfg.small_s_attn)
        ctx = ctx.transpose(1, 2).reshape(b, s, h)
        if cfg.proj_impl == "int8":
            out = fused_ffn.int8_dense(
                ctx.to(dt), self.output.weight, self.output.bias,
                quantized=(quantized.wo, quantized.so, quantized.bo))
        else:
            out = dense(self.output, ctx, dt)
        return layer_norm(self.output_layer_norm, out + hidden, dt,
                          cfg.layer_norm_eps)

    def _int8_qkv(self, x8: torch.Tensor, ql: QuantizedLayer):
        """q, k, v under ``proj_impl="int8"``: where the shapes tile, ONE
        K13 call over the concatenated [Wq; Wk; Wv] (the codes of x and
        every channel's scale are those of the JAX package's three
        ``int8_dense`` calls, ``simxns_tpu/models/bert.py:264-269``); else
        the three unquantized projections ``int8_dense`` returns there."""
        b, s, h = x8.shape
        if fused_ffn.int8_dense_tile(b * s, h, 3 * h) is None:
            return [fused_ffn.linear_dt(x8, m.weight, m.bias, x8.dtype)
                    for m in (self.query, self.key, self.value)]
        qkv = fused_ffn.int8_dense_fwd(x8.reshape(b * s, h).contiguous(),
                                       ql.wqkv, ql.sqkv, ql.bqkv)
        return qkv.view(b, s, 3 * h).split(h, dim=-1)


class BertLayer(nn.Module):
    """Post-LN transformer block (attention + GELU FFN), HF-BERT layout."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = BertSelfAttention(cfg)
        self.intermediate = _linear(cfg.hidden_size, cfg.intermediate_size,
                                    cfg)
        self.output = _linear(cfg.intermediate_size, cfg.hidden_size, cfg)
        self.output_layer_norm = _ln(cfg.hidden_size, cfg)
        # the int8 weights, {"key": ..., "layer": QuantizedLayer}; a view
        # over the same Parameters shares this dict (share_parameters)
        self._qbox = {}

    def kernel_params(self) -> dict:
        """This layer's weights under the TPU layer kernel's names."""
        att = self.attention
        return {
            "wq": att.query.weight, "bq": att.query.bias,
            "wk": att.key.weight, "bk": att.key.bias,
            "wv": att.value.weight, "bv": att.value.bias,
            "wo": att.output.weight, "bo": att.output.bias,
            "ln1_scale": att.output_layer_norm.weight,
            "ln1_bias": att.output_layer_norm.bias,
            "w1": self.intermediate.weight, "b1": self.intermediate.bias,
            "w2": self.output.weight, "b2": self.output.bias,
            "ln2_scale": self.output_layer_norm.weight,
            "ln2_bias": self.output_layer_norm.bias,
        }

    def quantized(self) -> QuantizedLayer:
        """The int8 weights, quantized once and again only after a
        parameter changes (in place or by assignment)."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._qbox.get("key") != key:
            self._qbox.clear()
            self._qbox.update(key=key,
                              layer=quantize_layer(self.kernel_params()))
        return self._qbox["layer"]

    def drop_quantized(self) -> None:
        """Free the cached int8 weights (for this layer and every view that
        shares its Parameters); the next encode quantizes again."""
        self._qbox.clear()

    def forward(self, hidden: torch.Tensor,
                attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        if cfg.layer_impl == "fused_int8":
            _guard_quantized_under_grad(self, hidden,
                                        "layer_impl='fused_int8'")
            return fused_encoder_layer_int8(
                hidden.to(dt), attention_mask, quantized=self.quantized(),
                num_heads=cfg.num_heads, layer_norm_eps=cfg.layer_norm_eps)
        ql = None
        if "int8" in (cfg.proj_impl, cfg.ffn_impl):
            knob = ("proj_impl" if cfg.proj_impl == "int8" else "ffn_impl")
            _guard_quantized_under_grad(self, hidden, f"{knob}='int8'")
            ql = self.quantized()
        attn_out = self.attention(hidden, attention_mask, ql)
        if cfg.ffn_impl == "int8":
            out = fused_ffn.int8_ffn(
                attn_out.to(dt), self.intermediate.weight,
                self.intermediate.bias, self.output.weight, self.output.bias,
                quantized=(ql.w1, ql.s1, ql.b1, ql.w2, ql.s2, ql.b2))
        elif cfg.ffn_impl != "xla":
            out = fused_ffn.ffn(attn_out.to(dt), self.intermediate.weight,
                                self.intermediate.bias, self.output.weight,
                                self.output.bias, cfg.ffn_impl)
        else:
            inter = dense(self.intermediate, attn_out, dt)
            inter = torch.nn.functional.gelu(
                inter.float(),
                approximate="tanh" if cfg.gelu == "tanh" else "none").to(dt)
            out = dense(self.output, inter, dt)
        return layer_norm(self.output_layer_norm, out + attn_out, dt,
                          cfg.layer_norm_eps)


class BertEncoder(nn.Module):
    """Token ids -> contextual hiddens + CLS pooled vector."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.layers = nn.ModuleList(BertLayer(cfg)
                                    for _ in range(cfg.num_layers))

    def _remat(self) -> bool:
        """Whether this call checkpoints its layers: ``cfg.remat`` while
        autograd records (an encode under ``torch.no_grad()`` has nothing
        to recompute)."""
        cfg = self.cfg
        if not cfg.remat:
            return False
        if cfg.remat_policy == "dots":
            raise NotImplementedError(
                "remat_policy='dots' (save the matmul outputs, recompute the "
                "elementwise work) is not ported yet (ROADMAP.md Queue 1, "
                "item 3)")
        if cfg.remat_policy is not None:
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
        return torch.is_grad_enabled()

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None, *,
                output_hidden_states: bool = False) -> EncoderOutput:
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.int32,
                                        device=input_ids.device)
        x = self.embeddings(input_ids, token_type_ids)
        hidden = [x] if output_hidden_states else None
        remat = self._remat()
        for layer in self.layers:
            if remat:
                # nothing random runs in a layer: no RNG state to restore
                x = checkpoint(layer, x, attention_mask, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, attention_mask)
            if output_hidden_states:
                hidden.append(x)
        return EncoderOutput(last_hidden_state=x, pooled=x[:, 0],
                             hidden_states=hidden)


def share_parameters(view: nn.Module, model: nn.Module) -> nn.Module:
    """Point every parameter of ``view`` (a model of the same structure,
    built on the meta device) at ``model``'s ``Parameter`` objects, and
    give each of its layers the model layer's int8 cache. Nothing is
    copied; ``view`` follows every in-place update of ``model``."""
    for name, param in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        setattr(view.get_submodule(owner), leaf, param)
    mine = [m for m in view.modules() if isinstance(m, BertLayer)]
    theirs = [m for m in model.modules() if isinstance(m, BertLayer)]
    for v_layer, m_layer in zip(mine, theirs):
        v_layer._qbox = m_layer._qbox
    return view


def init_weights(module: nn.Module, std: float,
                 generator: torch.Generator) -> None:
    """The JAX package's initializers: normal(std) for dense kernels and
    embedding tables, zero biases, unit LayerNorm scales."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

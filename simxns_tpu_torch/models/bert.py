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
parameters are the same under every knob. ``layer_impl="fused_int8"`` runs
each layer on the Hopper kernels of :mod:`simxns_tpu_torch.ops.fused_layer`
(encode only, under ``torch.no_grad()``); its int8 weights, and those of
the two int8 knobs, are cached per layer and quantized again whenever a
parameter changes, so an encode-only view that shares a training model's
``Parameter`` objects (:func:`share_parameters`, the ``int8_view`` of
either model) follows every optimizer update. In train mode, and for a
call that asks for attention maps, ``fused_int8`` gives way to the
standard composition, as in JAX. On the card a layer whose shape the JAX
TPU kernel does not take (``fused_layer.reaches_kernels``: H or F off the
128 grid, or one sequence past its stack budget) computes the unquantized
f32 ``layer_reference``, as JAX does there; on the CPU the quantized
composition runs at every shape, as JAX's interpreted kernel does.

Train mode is a call with a ``torch.Generator`` (None is eval mode): dropout
(``hidden_dropout`` after the embeddings' LayerNorm and on the attention
and FFN outputs before their residual; ``attention_dropout`` on the
probabilities) then draws its masks through
:mod:`simxns_tpu_torch.ops.dropout`. The encoder draws one seed per layer
from the caller's generator, and each layer builds its own generator from
its seed, so a layer recomputed under remat draws the same masks again.
The attention dropout needs the probabilities, so with
``attention_dropout > 0`` in train mode the attention takes the plain path
and K5-K8 do not run, as in JAX; with ``attention_dropout=0`` and
``hidden_dropout > 0`` the attention kernels still run, and so do K9-K11
under ``ffn_impl="fused_vjp"``.

``remat=True`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, per layer, as the JAX ``run_layers``);
``remat_policy="dots"`` (``dots_with_no_batch_dims_saveable``) keeps the
outputs of the dense products (``aten.mm``/``aten.addmm``: q, k, v, the
attention output, the FFN's two products) and recomputes everything else:
the elementwise work, LayerNorm, softmax, the batched attention products
and every hand-written kernel's output (a Pallas output is no dot in JAX
either). A call that asks for attention maps is not rematerialised.
``embed`` gives the embeddings alone, :class:`MLMHead` the MLM classifier
and :func:`truncate_layers` the first layers of a deeper state_dict.
Parameter names follow the JAX tree (``layers.{i}`` for ``layer_{i}``);
:func:`simxns_tpu_torch.models.convert.params_from_jax` maps a flax tree
onto them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from simxns_tpu_torch.ops import dropout as drop
from simxns_tpu_torch.ops import fused_ffn
from simxns_tpu_torch.ops.attention import multi_head_attention
from simxns_tpu_torch.ops.fused_layer import (QuantizedLayer,
                                              fused_encoder_layer_int8,
                                              layer_reference,
                                              quantize_layer, reaches_kernels)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2           # 0 = no token-type embeddings
    hidden_dropout: float = 0.1        # train mode only (a generator)
    attention_dropout: float = 0.1
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
                    max_position_embeddings=128, hidden_dropout=0.0,
                    attention_dropout=0.0, dtype=torch.float32)
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
    hidden_states: Optional[Tuple[torch.Tensor, ...]] = None  # L+1 x [B, S, H]
    attentions: Optional[Tuple[torch.Tensor, ...]] = None  # L x [B, heads, S, S]


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
                position_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: train mode's dropout after the LayerNorm."""
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
        x = drop.dropout(x, cfg.hidden_dropout, generator)
        if hasattr(self, "embeddings_project"):
            x = dense(self.embeddings_project, x, dt)
        return x


class BertSelfAttention(nn.Module):
    """q/k/v projections, attention, output projection, residual + LN."""

    tp = None      # parallel.tp.TensorParallel once its weights are split

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
                quantized: Optional[QuantizedLayer] = None, *,
                generator: Optional[torch.Generator] = None,
                output_attention: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (output, probabilities or None). ``quantized``: the layer's
        int8 weights (:meth:`BertLayer.quantized`), which
        ``proj_impl="int8"`` runs on; ``generator``: train mode's dropout
        (the probabilities, then the output before its residual)."""
        cfg, dt = self.cfg, self.cfg.dtype
        if self.tp is not None:
            return self._forward_tp(hidden, attention_mask, generator,
                                    output_attention)
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
        ctx, probs = multi_head_attention(
            split(q), split(k), split(v), attention_mask,
            impl=cfg.attention_impl, return_probs=output_attention,
            dropout_rate=cfg.attention_dropout, generator=generator,
            small_s_impl=cfg.small_s_attn)
        ctx = ctx.transpose(1, 2).reshape(b, s, h)
        if cfg.proj_impl == "int8":
            out = fused_ffn.int8_dense(
                ctx.to(dt), self.output.weight, self.output.bias,
                quantized=(quantized.wo, quantized.so, quantized.bo))
        else:
            out = dense(self.output, ctx, dt)
        out = drop.dropout(out, cfg.hidden_dropout, generator)
        return layer_norm(self.output_layer_norm, out + hidden, dt,
                          cfg.layer_norm_eps), probs

    def _forward_tp(self, hidden, attention_mask, generator,
                    output_attention):
        """The split layer (``parallel.tp``): q, k, v of this rank's heads
        (column-split), the attention over them, the row-split output
        summed over the model group. Where the heads do not divide by the
        model size, q, k and v are gathered and every rank attends over
        all heads, then keeps its columns of the context."""
        cfg, dt, tp = self.cfg, self.cfg.dtype, self.tp
        b, s, h = hidden.shape
        d = h // cfg.num_heads
        x = tp.copy_in(hidden)
        q, k, v = (dense(m, x, dt) for m in (self.query, self.key,
                                              self.value))
        local = q.shape[-1]
        attn_gen = generator
        if cfg.num_heads % tp.size == 0:
            heads = cfg.num_heads // tp.size
            if generator is not None and cfg.attention_dropout > 0.0:
                # the probabilities of other heads than the other model
                # ranks'; the layer's own stream stays the same on every
                # rank (it drops the replicated hiddens)
                attn_gen = drop.generator(
                    drop.seeds(generator, 1)[0] ^ (tp.rank << 40),
                    generator.device)
        else:
            heads = cfg.num_heads
            q, k, v = (tp.gather(t, -1, summed=True) for t in (q, k, v))
        width = heads * d

        def split(x):
            return x.reshape(b, s, heads, d).transpose(1, 2)

        ctx, probs = multi_head_attention(
            split(q), split(k), split(v), attention_mask,
            impl=cfg.attention_impl, return_probs=output_attention,
            dropout_rate=cfg.attention_dropout, generator=attn_gen,
            small_s_impl=cfg.small_s_attn)
        ctx = ctx.transpose(1, 2).reshape(b, s, width)
        if width != local:
            ctx = ctx[..., tp.rank * local:(tp.rank + 1) * local]
        out = tp.row_dense(self.output, ctx, dt)
        out = drop.dropout(out, cfg.hidden_dropout, generator)
        return layer_norm(self.output_layer_norm, out + hidden, dt,
                          cfg.layer_norm_eps), probs

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

    tp = None      # parallel.tp.TensorParallel once its weights are split

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
                attention_mask: Optional[torch.Tensor], *,
                generator: Optional[torch.Generator] = None,
                output_attention: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (output, attention probabilities or None). ``generator``
        draws train mode's dropout masks (None in eval mode)."""
        cfg, dt = self.cfg, self.cfg.dtype
        fused_layer = (cfg.layer_impl == "fused_int8" and generator is None
                       and not output_attention)
        if self.tp is not None and (fused_layer or cfg.ffn_impl != "xla"
                                    or cfg.proj_impl != "xla"):
            # a kernel over the layer's whole weights (JAX: GSPMD gathers
            # the kernel's operands)
            return self.tp.whole(self, hidden, attention_mask,
                                 generator=generator,
                                 output_attention=output_attention)
        if fused_layer:
            _guard_quantized_under_grad(self, hidden,
                                        "layer_impl='fused_int8'")
            if hidden.is_cuda and not reaches_kernels(
                    hidden.shape[1], hidden.shape[2], cfg.intermediate_size):
                # the JAX package's TPU dispatch (fused_layer.py:170-189):
                # off the 128 grid or past the stack budget, the f32 layer
                return layer_reference(
                    hidden.to(dt), attention_mask, self.kernel_params(),
                    num_heads=cfg.num_heads,
                    layer_norm_eps=cfg.layer_norm_eps), None
            return fused_encoder_layer_int8(
                hidden.to(dt), attention_mask, quantized=self.quantized(),
                num_heads=cfg.num_heads,
                layer_norm_eps=cfg.layer_norm_eps), None
        ql = None
        if "int8" in (cfg.proj_impl, cfg.ffn_impl):
            knob = ("proj_impl" if cfg.proj_impl == "int8" else "ffn_impl")
            _guard_quantized_under_grad(self, hidden, f"{knob}='int8'")
            ql = self.quantized()
        attn_out, probs = self.attention(
            hidden, attention_mask, ql, generator=generator,
            output_attention=output_attention)
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
            tp = self.tp       # the split FFN: column, then row (+ its sum)
            inter = dense(self.intermediate,
                          attn_out if tp is None else tp.copy_in(attn_out),
                          dt)
            inter = torch.nn.functional.gelu(
                inter.float(),
                approximate="tanh" if cfg.gelu == "tanh" else "none").to(dt)
            out = (dense(self.output, inter, dt) if tp is None
                   else tp.row_dense(self.output, inter, dt))
        out = drop.dropout(out, cfg.hidden_dropout, generator)
        return layer_norm(self.output_layer_norm, out + attn_out, dt,
                          cfg.layer_norm_eps), probs


# remat_policy="dots": the outputs of the dense products are kept; the
# batched attention products (aten.bmm) are dots with batch dims, which
# JAX's dots_with_no_batch_dims_saveable recomputes too
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS = functools.partial(create_selective_checkpoint_contexts, _save_dots)


class BertEncoder(nn.Module):
    """Token ids -> contextual hiddens + CLS pooled vector.

    ``output_hidden_states``/``output_attentions`` give every layer's
    hiddens and attention probabilities (LEAD); :meth:`embed` the
    embedding sublayer alone (MASTER's Condenser heads).
    """

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.layers = nn.ModuleList(BertLayer(cfg)
                                    for _ in range(cfg.num_layers))

    def _remat(self):
        """The checkpoint ``context_fn`` of this call, or None when it does
        not rematerialise: ``cfg.remat`` while autograd records (an encode
        under ``torch.no_grad()`` has nothing to recompute)."""
        cfg = self.cfg
        if not cfg.remat:
            return None
        if cfg.remat_policy not in (None, "dots"):
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
        if not torch.is_grad_enabled():
            return None
        return _DOTS if cfg.remat_policy == "dots" else noop_context_fn

    def embed(self, input_ids: torch.Tensor,
              token_type_ids: Optional[torch.Tensor] = None, *,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Fresh (position-aware) embeddings of a token sequence."""
        gen = None
        if generator is not None:
            gen = drop.generator(drop.seeds(generator, 1)[0],
                                 input_ids.device)
        return self.embeddings(input_ids, token_type_ids, generator=gen)

    def run_layers(self, hidden: torch.Tensor,
                   attention_mask: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   output_hidden_states: bool = False,
                   output_attentions: bool = False):
        """-> (last hiddens, every layer's hiddens or None, every layer's
        probabilities or None)."""
        n = len(self.layers)
        seeds = (drop.seeds(generator, n) if generator is not None
                 else [None] * n)
        context_fn = None if output_attentions else self._remat()
        all_hidden = [hidden] if output_hidden_states else None
        all_attn = [] if output_attentions else None
        x = hidden
        for layer, seed in zip(self.layers, seeds):
            # the layer's generator is built inside the call from its seed:
            # a recompute under remat draws the same masks again
            def call(h, layer=layer, seed=seed):
                g = None if seed is None else drop.generator(seed, h.device)
                return layer(h, attention_mask, generator=g,
                             output_attention=output_attentions)

            if context_fn is not None:
                # nothing random draws from the global generators: no RNG
                # state to restore
                x = checkpoint(lambda h, call=call: call(h)[0], x,
                               use_reentrant=False, preserve_rng_state=False,
                               context_fn=context_fn)
                probs = None
            else:
                x, probs = call(x)
            if output_hidden_states:
                all_hidden.append(x)
            if output_attentions:
                all_attn.append(probs)
        return x, all_hidden, all_attn

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                output_hidden_states: bool = False,
                output_attentions: bool = False) -> EncoderOutput:
        """A ``generator`` is train mode (dropout on)."""
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.int32,
                                        device=input_ids.device)
        x = self.embed(input_ids, token_type_ids, generator=generator)
        x, hidden, attn = self.run_layers(
            x, attention_mask, generator=generator,
            output_hidden_states=output_hidden_states,
            output_attentions=output_attentions)
        return EncoderOutput(
            last_hidden_state=x, pooled=x[:, 0],
            hidden_states=tuple(hidden) if output_hidden_states else None,
            attentions=tuple(attn) if output_attentions else None)


class MLMHead(nn.Module):
    """BERT's MLM classifier (``BertOnlyMLMHead``): a dense transform,
    exact GELU and LayerNorm, then the vocab projection. ``tied=True``
    projects onto the word-embedding table passed to :meth:`forward` (f32
    accumulation, plus the head's own ``bias``), as HF ties it; else an
    untied ``decoder`` is learned. Logits are f32 [..., vocab]."""

    tp = None      # parallel.tp.TensorParallel once its decoder is split

    def __init__(self, cfg: BertConfig, tied: bool = True):
        super().__init__()
        self.cfg = cfg
        self.tied = tied
        h = cfg.hidden_size
        self.transform = _linear(h, h, cfg)
        self.transform_layer_norm = _ln(h, cfg)
        if tied:
            self.bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                 dtype=cfg.param_dtype))
        else:
            self.decoder = _linear(h, cfg.vocab_size, cfg)

    def forward(self, hidden: torch.Tensor,
                shared_embedding: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        if self.tied != (shared_embedding is not None):
            raise ValueError(
                "a tied MLMHead takes the word-embedding table [V, H], an "
                "untied one none")
        x = dense(self.transform, hidden, dt)
        x = torch.nn.functional.gelu(x.float()).to(dt)
        x = layer_norm(self.transform_layer_norm, x, dt, cfg.layer_norm_eps)
        if shared_embedding is None:
            if self.tp is not None:
                # the vocabulary-split logits, gathered (every rank then
                # computes the same loss over the whole vocabulary)
                return self.tp.gather(
                    dense(self.decoder, self.tp.copy_in(x), dt).float())
            return dense(self.decoder, x, dt).float()
        # products of dt values, accumulated and returned in f32 (the
        # einsum's preferred_element_type); a plain product, no kernel
        logits = torch.matmul(x.float(), shared_embedding.to(dt).float().T)
        return logits + self.bias.float()


_LAYER_KEY = re.compile(r"(?:^|\.)layers\.(\d+)\.")


def truncate_layers(state: Mapping[str, torch.Tensor],
                    num_layers: int) -> Dict[str, torch.Tensor]:
    """Keep the embeddings and the first ``num_layers`` layers of a
    state_dict (``...layers.{i}....`` names): the PROD student init, whose
    n-layer student starts from a deeper teacher's first n layers
    (``simxns_tpu/models/bert.py:538-553``)."""
    out = {}
    for key, val in state.items():
        m = _LAYER_KEY.search(key)
        if m is None or int(m.group(1)) < num_layers:
            out[key] = val
    return out


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
    for v_mod, m_mod in zip(view.modules(), model.modules()):
        if getattr(m_mod, "tp", None) is not None:
            v_mod.tp = m_mod.tp          # the split layers of parallel.tp
    return view


def skip_init(on: bool = True):
    """The context a model builds its layers in when every parameter is
    filled afterwards, drawn by :func:`init_weights` or loaded by
    :func:`from_state_dict`: the meta device, so PyTorch's own initializers,
    whose values would be overwritten, do not run (half the construction
    time of BERT-base). With ``on`` false, no context."""
    return torch.device("meta") if on else contextlib.nullcontext()


def from_state_dict(cls, cfg, state_dict: dict) -> nn.Module:
    """``cls(cfg)`` built under :func:`skip_init` and holding
    ``state_dict``'s tensors (strict names; a tied table once)."""
    with skip_init():
        model = cls(cfg)
    model.load_state_dict(state_dict, assign=True)
    return model


def init_weights(module: nn.Module, std: float,
                 generator: torch.Generator) -> None:
    """The JAX package's initializers: normal(std) for dense kernels and
    embedding tables, zero biases, unit LayerNorm scales. A module built on
    the meta device (:func:`skip_init`) gets its CPU storage here, every
    parameter zero before the draws (the MLM head's own bias is zero)."""
    with torch.no_grad():
        if any(p.is_meta for p in module.parameters()):
            module.to_empty(device="cpu")
            for p in module.parameters():
                p.zero_()
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

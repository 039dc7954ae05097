"""T5 encoder-decoder (port of ``simxns_tpu/models/t5.py``), the
docT5query generator of CAPSTONE.

The reference warm-starts doc2query generation from
``castorini/doc2query-t5-base-msmarco`` (``CAPSTONE/models/
generate_query.py:115-235``). This is the T5 v1.0 architecture itself, so
:func:`simxns_tpu_torch.models.hf_import.convert_hf_t5` loads real
checkpoints: RMS layer norm (variance in f32), pre-LN blocks, a bucketed
relative-position bias held by each stack's first table
(``enc_rel_bias``, ``dec_rel_bias``) and shared by all its blocks, no
position bias in cross-attention, bias-free dense layers, a ReLU FFN,
**unscaled** attention scores (T5 folds 1/sqrt(d) into its initializer)
with an f32 softmax cast back to ``cfg.dtype``, and a tied LM head that
scales the decoder output by ``d_model**-0.5``; logits are f32.

Its attention (a learned bias added to unscaled scores) is outside the
contract of the attention kernels K5-K8, so it is plain PyTorch on every
device, as it is plain XLA in JAX.

:func:`generate` samples top-k (temperature first, then every logit
``>= `` the k-th kept: ties keep more than k), starting from PAD (0); EOS
is 1 and a finished row emits PAD. It decodes incrementally: each decoder
layer caches its self-attention keys and values, and the cross-attention
keys and values are computed once a batch. Under the causal mask position
t sees only positions up to t, so a step's logits are those of the JAX
package's re-run of the teacher-forcing decoder at every position
(:meth:`T5.decode`), at a fraction of the work. A step has the same
shapes at every position (the keys past t are masked, not cut), so on
the card it is captured once as a CUDA graph and replayed. Sampling draws
from a ``torch.Generator`` seeded from ``rng_seed``.

Parameter names follow the flax tree (``enc_blocks.{i}`` for
``enc_blocks_{i}``); :func:`simxns_tpu_torch.models.convert.params_from_jax`
maps a JAX tree onto them. A call with a ``torch.Generator`` trains with
dropout.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from simxns_tpu_torch.models.bert import dense
from simxns_tpu_torch.models.seq2seq import (NEG, key_bias, queries_to_tsv,
                                             sample_top_k)
from simxns_tpu_torch.ops import dropout as drop


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64                       # per-head width (inner = heads*d_kv)
    d_ff: int = 3072
    num_layers: int = 12
    num_decoder_layers: Optional[int] = None
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dropout_rate: float = 0.1
    tie_word_embeddings: bool = True     # v1.0 ties; output * d_model**-0.5
    initializer_factor: float = 1.0
    pad_id: int = 0                      # decoding starts from PAD
    eos_id: int = 1
    max_target_length: int = 64          # the reference's generate() default
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def n_dec(self) -> int:
        return self.num_decoder_layers or self.num_layers

    def replace(self, **kw) -> "T5Config":
        return dataclasses.replace(self, **kw)


class RMSNorm(nn.Module):
    """T5LayerNorm: no mean, no bias; the variance of the f32 input, then
    ``weight * y`` with ``y`` cast to ``dtype``."""

    def __init__(self, width: int, eps: float, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(width, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (self.weight * y.to(self.dtype)).to(self.dtype)


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """HF ``T5Attention._relative_position_bucket`` for ``relative_position
    = key_pos - query_pos`` (int32): bidirectional (the encoder) splits the
    buckets between past and future, unidirectional (the decoder) buckets
    only the past; near positions get exact buckets, far ones log-spaced.
    The log ratio is taken in f32 (both logs) and truncated toward zero,
    as in JAX."""
    rp = relative_position.to(torch.int32)
    buckets = torch.zeros_like(rp)
    if bidirectional:
        num_buckets //= 2
        buckets = (rp > 0).to(torch.int32) * num_buckets
        rp = rp.abs()
    else:
        rp = -torch.clamp(rp, max=0)
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    rp_f = torch.clamp(rp.float(), min=1.0)
    denom = torch.log(torch.tensor(max_distance / max_exact,
                                   dtype=torch.float32, device=rp.device))
    large = max_exact + (torch.log(rp_f / max_exact) / denom
                         * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(is_small, rp, large)


def _linear(i: int, o: int, cfg: T5Config) -> nn.Linear:
    return nn.Linear(i, o, bias=False, dtype=cfg.param_dtype)


class T5Attention(nn.Module):
    """q, k, v, o without bias; unscaled f32 scores plus ``bias`` (the
    relative-position bias and the masks), f32 softmax cast to ``dtype``."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = _linear(cfg.d_model, inner, cfg)
        self.k = _linear(cfg.d_model, inner, cfg)
        self.v = _linear(cfg.d_model, inner, cfg)
        self.o = _linear(inner, cfg.d_model, cfg)

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return x.reshape(b, s, self.cfg.num_heads, self.cfg.d_kv).transpose(
            1, 2)

    def kv(self, kv_in: torch.Tensor):
        """The keys and values of ``kv_in``, [B, heads, S, d_kv] each."""
        dt = self.cfg.dtype
        return (self.heads(dense(self.k, kv_in, dt)),
                self.heads(dense(self.v, kv_in, dt)))

    def attend(self, q_in: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        q = self.heads(dense(self.q, q_in, dt))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = torch.softmax(scores + bias.float(), dim=-1).to(dt)
        probs = drop.dropout(probs, cfg.dropout_rate, generator)
        ctx = torch.matmul(probs.float(), v.float()).to(dt)
        b, h, s, d = ctx.shape
        return dense(self.o, ctx.transpose(1, 2).reshape(b, s, h * d), dt)

    def forward(self, q_in, kv_in, bias, generator=None):
        k, v = self.kv(kv_in)
        return self.attend(q_in, k, v, bias, generator)


class T5Block(nn.Module):
    """Pre-LN: ``x += dropout(attn(norm(x)))``; the decoder's
    cross-attention likewise; then the ReLU FFN."""

    def __init__(self, cfg: T5Config, is_decoder: bool):
        super().__init__()
        self.cfg = cfg
        self.is_decoder = is_decoder

        def norm():
            return RMSNorm(cfg.d_model, cfg.layer_norm_eps, cfg.dtype,
                           cfg.param_dtype)

        self.self_norm = norm()
        self.self_attention = T5Attention(cfg)
        if is_decoder:
            self.cross_norm = norm()
            self.cross_attention = T5Attention(cfg)
        self.ffn_norm = norm()
        self.wi = _linear(cfg.d_model, cfg.d_ff, cfg)
        self.wo = _linear(cfg.d_ff, cfg.d_model, cfg)

    def ffn(self, x, generator=None):
        cfg, dt = self.cfg, self.cfg.dtype
        h = torch.relu(dense(self.wi, self.ffn_norm(x), dt))
        h = drop.dropout(h, cfg.dropout_rate, generator)
        y = dense(self.wo, h, dt)
        return x + drop.dropout(y, cfg.dropout_rate, generator)

    def forward(self, x, self_bias, enc_hidden=None, cross_bias=None, *,
                generator: Optional[torch.Generator] = None):
        rate = self.cfg.dropout_rate
        normed = self.self_norm(x)
        y = self.self_attention(normed, normed, self_bias, generator)
        x = x + drop.dropout(y, rate, generator)
        if self.is_decoder:
            y = self.cross_attention(self.cross_norm(x), enc_hidden,
                                     cross_bias, generator)
            x = x + drop.dropout(y, rate, generator)
        return self.ffn(x, generator)


@dataclasses.dataclass
class DecodeCache:
    """The incremental decoder's state for one batch: each decoder layer's
    self-attention keys and values [B, heads, t_max, d_kv] (filled up to
    the current step) and its cross-attention keys and values over the
    encoder output, with the encoder's key bias [B, 1, 1, S]."""

    self_k: List[torch.Tensor]
    self_v: List[torch.Tensor]
    cross_k: List[torch.Tensor]
    cross_v: List[torch.Tensor]
    cross_bias: torch.Tensor
    pos_bias: torch.Tensor              # [1, heads, t_max, t_max]


class T5(nn.Module):
    """``T5ForConditionalGeneration``: :meth:`encode`, the teacher-forcing
    :meth:`decode` (logits [B, T, V] f32), and the incremental decoder
    (:meth:`start_decode`, :meth:`decode_step`) that :func:`generate`
    runs. ``generator`` seeds the JAX package's initializers; pass a
    converted state_dict to ``load_state_dict`` instead."""

    def __init__(self, cfg: T5Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        self.shared_embed = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                         dtype=pd)
        self.enc_rel_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                         cfg.num_heads, dtype=pd)
        self.dec_rel_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                         cfg.num_heads, dtype=pd)
        self.enc_blocks = nn.ModuleList(T5Block(cfg, is_decoder=False)
                                        for _ in range(cfg.num_layers))
        self.dec_blocks = nn.ModuleList(T5Block(cfg, is_decoder=True)
                                        for _ in range(cfg.n_dec))
        self.enc_final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps,
                                      cfg.dtype, pd)
        self.dec_final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps,
                                      cfg.dtype, pd)
        if not cfg.tie_word_embeddings:
            self.lm_head = _linear(cfg.d_model, cfg.vocab_size, cfg)
        if generator is not None:
            self._init(generator)

    @torch.no_grad()
    def _init(self, gen: torch.Generator) -> None:
        """The JAX module's initializers (``t5.py:117-131, 176-181,
        214-229``): normal tables, T5's per-projection scales, unit norms;
        the untied head flax's LeCun normal (truncated at 2 std)."""
        cfg = self.cfg
        f = cfg.initializer_factor
        inner = cfg.num_heads * cfg.d_kv
        for table in (self.shared_embed, self.enc_rel_bias,
                      self.dec_rel_bias):
            table.weight.normal_(0.0, f, generator=gen)
        for blk in list(self.enc_blocks) + list(self.dec_blocks):
            atts = [blk.self_attention]
            if blk.is_decoder:
                atts.append(blk.cross_attention)
            for att in atts:
                att.q.weight.normal_(0.0, f * (cfg.d_model * cfg.d_kv)
                                     ** -0.5, generator=gen)
                att.k.weight.normal_(0.0, f * cfg.d_model ** -0.5,
                                     generator=gen)
                att.v.weight.normal_(0.0, f * cfg.d_model ** -0.5,
                                     generator=gen)
                att.o.weight.normal_(0.0, f * inner ** -0.5, generator=gen)
            blk.wi.weight.normal_(0.0, f * cfg.d_model ** -0.5,
                                  generator=gen)
            blk.wo.weight.normal_(0.0, f * cfg.d_ff ** -0.5, generator=gen)
        if not cfg.tie_word_embeddings:
            std = cfg.d_model ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(self.lm_head.weight, 0.0, std, -2 * std,
                                  2 * std, generator=gen)

    def _pos_bias(self, table: nn.Embedding, qlen: int, klen: int,
                  bidirectional: bool) -> torch.Tensor:
        """[1, heads, qlen, klen] f32."""
        cfg = self.cfg
        dev = table.weight.device
        q_pos = torch.arange(qlen, dtype=torch.int32, device=dev)[:, None]
        k_pos = torch.arange(klen, dtype=torch.int32, device=dev)[None, :]
        buckets = relative_position_bucket(
            k_pos - q_pos, bidirectional,
            cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        vals = table.weight.float()[buckets.long()]     # [q, k, heads]
        return vals.permute(2, 0, 1)[None]

    def _embed(self, ids: torch.Tensor, generator) -> torch.Tensor:
        x = self.shared_embed.weight.to(self.cfg.dtype)[ids.long()]
        return drop.dropout(x, self.cfg.dropout_rate, generator)

    def encode(self, enc_ids: torch.Tensor, enc_mask: torch.Tensor, *,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        s = enc_ids.shape[1]
        x = self._embed(enc_ids, generator)
        bias = (self._pos_bias(self.enc_rel_bias, s, s, True)
                + key_bias(enc_mask))
        for blk in self.enc_blocks:
            x = blk(x, bias, generator=generator)
        x = self.enc_final_norm(x)
        return drop.dropout(x, self.cfg.dropout_rate, generator)

    def _logits(self, x: torch.Tensor, generator) -> torch.Tensor:
        """The final norm, dropout and the LM head: f32 logits."""
        cfg = self.cfg
        x = self.dec_final_norm(x)
        x = drop.dropout(x, cfg.dropout_rate, generator)
        if cfg.tie_word_embeddings:
            # HF's T5ForConditionalGeneration scaling, in x's dtype
            x = x * x.new_full((), cfg.d_model ** -0.5)
            table = self.shared_embed.weight.to(x.dtype)
            return torch.matmul(x.float(), table.float().T)
        return dense(self.lm_head, x, cfg.dtype).float()

    def decode(self, dec_ids: torch.Tensor, dec_mask: torch.Tensor,
               enc_hidden: torch.Tensor, enc_mask: torch.Tensor, *,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The teacher-forcing decoder -> logits [B, T, V] (f32)."""
        t = dec_ids.shape[1]
        dev = dec_ids.device
        x = self._embed(dec_ids, generator)
        causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=dev))
        allowed = causal[None, None] & (dec_mask[:, None, None, :] > 0)
        self_bias = (self._pos_bias(self.dec_rel_bias, t, t, False)
                     + torch.where(allowed, torch.tensor(0.0, device=dev),
                                   torch.tensor(NEG, device=dev)))
        cross_bias = key_bias(enc_mask)
        for blk in self.dec_blocks:
            x = blk(x, self_bias, enc_hidden, cross_bias, generator=generator)
        return self._logits(x, generator)

    def forward(self, enc_ids, enc_mask, dec_ids, dec_mask, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        enc = self.encode(enc_ids, enc_mask, generator=generator)
        return self.decode(dec_ids, dec_mask, enc, enc_mask,
                           generator=generator)

    # --- the incremental decoder (eval mode) --------------------------------

    def start_decode(self, enc_hidden: torch.Tensor, enc_mask: torch.Tensor,
                     t_max: int, repeat: int = 1) -> DecodeCache:
        """A cache for decoding ``t_max`` positions of each row of
        ``enc_hidden`` ``repeat`` times (rows ``jnp.repeat``-ordered): every
        layer's cross-attention keys and values, projected once a row."""
        cfg = self.cfg
        b = enc_hidden.shape[0] * repeat
        shape = (b, cfg.num_heads, t_max, cfg.d_kv)
        cache = DecodeCache([], [], [], [], key_bias(
            enc_mask.repeat_interleave(repeat, dim=0)),
            self._pos_bias(self.dec_rel_bias, t_max, t_max, False))
        for blk in self.dec_blocks:
            k, v = blk.cross_attention.kv(enc_hidden)
            cache.cross_k.append(k.repeat_interleave(repeat, dim=0))
            cache.cross_v.append(v.repeat_interleave(repeat, dim=0))
            cache.self_k.append(enc_hidden.new_zeros(shape, dtype=cfg.dtype))
            cache.self_v.append(enc_hidden.new_zeros(shape, dtype=cfg.dtype))
        return cache

    def decode_step(self, tokens: torch.Tensor, t,
                    cache: DecodeCache) -> torch.Tensor:
        """The logits [B, V] (f32) at position ``t`` (an int or a 0-d int64
        tensor on the device) given the token there (``tokens`` [B]) and the
        cache of positions 0..t-1, which it extends with position t. Equal
        to ``decode(...)[:, t]`` over the same tokens with ``dec_mask`` ones
        up to t: the row's bias is the re-run's, -1e9 on the keys past t,
        whose probabilities are then exactly 0. Every shape is the same at
        every t, so one CUDA graph replays all the steps
        (:func:`generate`)."""
        dev = tokens.device
        pos = torch.as_tensor(t, dtype=torch.int64, device=dev).reshape(1)
        x = self._embed(tokens[:, None], None)               # [B, 1, D]
        keys = torch.arange(cache.pos_bias.shape[-1], device=dev)
        self_bias = (cache.pos_bias.index_select(2, pos)
                     + torch.where(keys <= pos, 0.0, NEG))
        for i, blk in enumerate(self.dec_blocks):
            att = blk.self_attention
            normed = blk.self_norm(x)
            k, v = att.kv(normed)
            cache.self_k[i].index_copy_(2, pos, k)
            cache.self_v[i].index_copy_(2, pos, v)
            y = att.attend(normed, cache.self_k[i], cache.self_v[i],
                           self_bias)
            x = x + y
            y = blk.cross_attention.attend(blk.cross_norm(x),
                                           cache.cross_k[i],
                                           cache.cross_v[i],
                                           cache.cross_bias)
            x = blk.ffn(x + y)
        return self._logits(x, None)[:, 0]


def _graphed_step(model: T5, cache: DecodeCache, rows: int):
    """``decode_step`` over ``cache`` captured once as a CUDA graph:
    ``step(tokens, t)`` copies the step's tokens and position into the
    graph's inputs and replays it (one launch from the host for the ~540
    kernels of a T5-base step). -> ``step``, whose logits tensor is
    rewritten by the next replay. ``step`` holds ``cache``: the graph
    reads and writes its tensors' memory, which must outlive it."""
    dev = model.shared_embed.weight.device
    tok = torch.zeros(rows, dtype=torch.int32, device=dev)
    pos = torch.zeros((), dtype=torch.int64, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        # a warm-up on the side stream, as CUDA graph capture asks; it
        # writes position 0 of the cache, which step 0 writes again
        model.decode_step(tok, pos, cache)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits = model.decode_step(tok, pos, cache)

    def step(tokens: torch.Tensor, t: int) -> torch.Tensor:
        tok.copy_(tokens)
        pos.fill_(t)
        graph.replay()
        return logits

    step.cache = cache
    return step


@torch.no_grad()
def generate(model: T5, enc_ids, enc_mask, rng_seed: int = 0, *,
             max_length: Optional[int] = None, top_k: int = 10,
             temperature: float = 1.0,
             num_return_sequences: int = 1) -> torch.Tensor:
    """Top-k sampling decode (``generate_query.py:115-235``:
    ``do_sample=True, top_k=10, num_return_sequences=N``) on the model's
    device. ``enc_ids``/``enc_mask``: [B, S] (numpy or tensors). Returns
    ``[B, N, max_length]`` int32: PAD first, then the samples, PAD after
    EOS. Each row is encoded once and its cross-attention keys and values
    repeated N times (``jnp.repeat`` order). On the card the decode step is
    one CUDA graph, replayed at every position."""
    cfg = model.cfg
    dev = model.shared_embed.weight.device
    t_max = max_length or cfg.max_target_length
    n = num_return_sequences
    enc_ids = torch.as_tensor(np.asarray(enc_ids), device=dev)
    enc_mask = torch.as_tensor(np.asarray(enc_mask), device=dev)
    b = enc_ids.shape[0]
    cache = model.start_decode(model.encode(enc_ids, enc_mask), enc_mask,
                               t_max, repeat=n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng_seed))
    tokens = torch.full((b * n, t_max), cfg.pad_id, dtype=torch.int32,
                        device=dev)
    done = torch.zeros(b * n, dtype=torch.bool, device=dev)
    step = (_graphed_step(model, cache, b * n) if dev.type == "cuda" else
            lambda tok, t: model.decode_step(tok, t, cache))
    for t in range(t_max - 1):
        logits = step(tokens[:, t], t)
        # HF's warper order: the temperature before the top-k filter
        nxt = sample_top_k(logits / temperature, top_k, gen).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, cfg.pad_id), nxt)
        tokens[:, t + 1] = nxt
        done = done | (nxt == cfg.eos_id)
    return tokens.reshape(b, n, t_max)


def doc2query_tsv(model: T5, tokenizer, passages, out_path: str, *,
                  num_queries: int = 5, max_src_length: int = 512,
                  max_length: int = 64, top_k: int = 10,
                  batch_size: int = 32, seed: int = 0) -> None:
    """Generate docT5query expansion queries for every passage and write
    the ``psg_id\\tq1\\tq2...`` TSV that CAPSTONE's ``--query-tsv`` (and
    :meth:`~simxns_tpu_torch.data.curriculum.QueryExpander.from_tsv`)
    reads: the reference's generation stage (``CAPSTONE/models/
    generate_query.py:115-235``). ``passages`` is an iterable of ``(psg_id,
    text)``; ``tokenizer`` must round-trip text (``encode``, ``decode``).
    Every batch is padded to ``batch_size`` x ``max_src_length``; batch i
    samples with seed ``seed + i``."""
    items = list(passages)
    ids_out, q_out = [], []
    for i, lo in enumerate(range(0, len(items), batch_size)):
        chunk = items[lo:lo + batch_size]
        enc = np.zeros((batch_size, max_src_length), np.int32)
        msk = np.zeros((batch_size, max_src_length), np.int32)
        for r, (_, text) in enumerate(chunk):
            try:                        # HF tokenizers need truncation=True
                toks = tokenizer.encode(text, max_length=max_src_length,
                                        truncation=True)
            except TypeError:
                toks = tokenizer.encode(text, max_length=max_src_length)
            toks = toks[:max_src_length]
            enc[r, :len(toks)] = toks
            msk[r, :len(toks)] = 1
        toks = generate(model, enc, msk, seed + i, max_length=max_length,
                        top_k=top_k,
                        num_return_sequences=num_queries).cpu().numpy()
        for r, (pid, _) in enumerate(chunk):
            qs = []
            for s in range(num_queries):
                row = toks[r, s]
                end = np.nonzero(row == model.cfg.eos_id)[0]
                row = row[1:int(end[0])] if len(end) else row[1:]
                qs.append(tokenizer.decode(row.tolist()).strip())
            ids_out.append(pid)
            q_out.append(qs)
    queries_to_tsv(out_path, ids_out, q_out)

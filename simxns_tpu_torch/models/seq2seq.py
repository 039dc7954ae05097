"""Encoder-decoder seq2seq for doc2query generation (port of
``simxns_tpu/models/seq2seq.py``).

The reference's CAPSTONE pipeline generates expansion queries with
``castorini/doc2query-t5-base-msmarco``: ``model.generate(max_length=64,
do_sample=True, top_k=10, num_return_sequences=num_query)`` per passage,
then writes ``query.tsv`` rows ``psg_id\\tq1\\t...\\tqN``
(``CAPSTONE/models/generate_query.py:115-235``). This module gives that
capability with the BERT-family blocks of the port: a shared word table,
learned absolute positions with an embedding LayerNorm per stack, the
port's :class:`~simxns_tpu_torch.models.bert.BertLayer` as the encoder,
and post-LN decoder layers (causal self-attention, cross-attention, GELU
FFN). :class:`~simxns_tpu_torch.models.t5.T5` is the architecture that
carries T5 checkpoints.

:func:`generate` samples top-k from BOS (1) to EOS (2), re-running the
teacher-forcing decoder at every position as the JAX package does; the
temperature divides the filtered logits. :func:`queries_to_tsv` writes
the TSV that
:meth:`~simxns_tpu_torch.data.curriculum.QueryExpander.from_tsv` reads.
Parameter names follow the flax tree (``enc_layers.{i}`` for
``enc_layer_{i}``). A call with a ``torch.Generator`` trains with dropout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from simxns_tpu_torch.models.bert import (BertConfig, BertLayer, dense,
                                          init_weights, layer_norm, skip_init)
from simxns_tpu_torch.ops import dropout as drop
from simxns_tpu_torch.ops.attention import _xla_attention

NEG = -1e9


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    bert: BertConfig                       # one shape for encoder and decoder
    num_decoder_layers: Optional[int] = None   # default: bert.num_layers
    max_target_length: int = 64            # the reference's generate() default
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = 0

    @property
    def n_dec(self) -> int:
        return self.num_decoder_layers or self.bert.num_layers


def _linear(i: int, o: int, cfg: BertConfig) -> nn.Linear:
    return nn.Linear(i, o, dtype=cfg.param_dtype)


def _ln(cfg: BertConfig) -> nn.LayerNorm:
    return nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                        dtype=cfg.param_dtype)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, h = x.shape
    return x.reshape(b, s, num_heads, h // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, nh, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, nh * d)


class _Attention(nn.Module):
    """Projections, the scaled attention with an additive bias (causal and
    key mask, or the encoder's key mask), the output projection, dropout,
    then LayerNorm over the residual with the query input."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = _linear(h, h, cfg)
        self.key = _linear(h, h, cfg)
        self.value = _linear(h, h, cfg)
        self.output = _linear(h, h, cfg)
        self.output_layer_norm = _ln(cfg)

    def forward(self, q_in, kv_in, bias, generator=None):
        cfg, dt = self.cfg, self.cfg.dtype
        q, k, v = (_split_heads(dense(m, x, dt), cfg.num_heads) for m, x in (
            (self.query, q_in), (self.key, kv_in), (self.value, kv_in)))
        ctx, _ = _xla_attention(q, k, v, bias, return_probs=False)
        out = dense(self.output, _merge_heads(ctx), dt)
        out = drop.dropout(out, cfg.hidden_dropout, generator)
        return layer_norm(self.output_layer_norm, out + q_in, dt,
                          cfg.layer_norm_eps)


class DecoderLayer(nn.Module):
    """Causal self-attention -> cross-attention -> GELU FFN (post-LN, the
    BERT layout)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.self_attention = _Attention(cfg)
        self.cross_attention = _Attention(cfg)
        self.intermediate = _linear(cfg.hidden_size, cfg.intermediate_size,
                                    cfg)
        self.output = _linear(cfg.intermediate_size, cfg.hidden_size, cfg)
        self.output_layer_norm = _ln(cfg)

    def forward(self, hidden, enc_hidden, self_bias, cross_bias,
                generator=None):
        cfg, dt = self.cfg, self.cfg.dtype
        x = self.self_attention(hidden, hidden, self_bias, generator)
        x = self.cross_attention(x, enc_hidden, cross_bias, generator)
        inter = dense(self.intermediate, x, dt)
        inter = torch.nn.functional.gelu(
            inter.float(),
            approximate="tanh" if cfg.gelu == "tanh" else "none").to(dt)
        out = dense(self.output, inter, dt)
        out = drop.dropout(out, cfg.hidden_dropout, generator)
        return layer_norm(self.output_layer_norm, out + x, dt,
                          cfg.layer_norm_eps)


def key_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, S] 1/0 key mask -> the additive [B, 1, 1, S] bias (0 or -1e9)."""
    return torch.where(mask[:, None, None, :] > 0,
                       torch.tensor(0.0, device=mask.device),
                       torch.tensor(NEG, device=mask.device))


class Seq2Seq(nn.Module):
    """The encoder-decoder with a shared word table. ``forward`` is the
    teacher-forcing pass (training); :func:`generate` samples.
    ``generator`` seeds the JAX package's initializers."""

    def __init__(self, cfg: Seq2SeqConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        bc = cfg.bert
        pd = bc.param_dtype
        with skip_init(generator is not None):
            self.shared_embed = nn.Embedding(bc.vocab_size, bc.hidden_size,
                                             dtype=pd)
            self.enc_pos = nn.Embedding(bc.max_position_embeddings,
                                        bc.hidden_size, dtype=pd)
            self.dec_pos = nn.Embedding(bc.max_position_embeddings,
                                        bc.hidden_size, dtype=pd)
            self.enc_norm = _ln(bc)
            self.dec_norm = _ln(bc)
            self.enc_layers = nn.ModuleList(BertLayer(bc)
                                            for _ in range(bc.num_layers))
            self.dec_layers = nn.ModuleList(DecoderLayer(bc)
                                            for _ in range(cfg.n_dec))
        if generator is not None:
            init_weights(self, bc.initializer_range, generator)

    def _embed(self, ids: torch.Tensor, pos_table: nn.Embedding,
               norm: nn.LayerNorm) -> torch.Tensor:
        bc = self.cfg.bert
        dt = bc.dtype
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = (self.shared_embed.weight.to(dt)[ids.long()]
             + pos_table.weight.to(dt)[pos][None])
        return layer_norm(norm, x, dt, bc.layer_norm_eps)

    def encode(self, enc_ids: torch.Tensor, enc_mask: torch.Tensor, *,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self._embed(enc_ids, self.enc_pos, self.enc_norm)
        for layer in self.enc_layers:
            x, _ = layer(x, enc_mask, generator=generator)
        return x

    def decode(self, dec_ids: torch.Tensor, dec_mask: torch.Tensor,
               enc_hidden: torch.Tensor, enc_mask: torch.Tensor, *,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The teacher-forcing decoder -> logits [B, T, V] (f32)."""
        t = dec_ids.shape[1]
        dev = dec_ids.device
        x = self._embed(dec_ids, self.dec_pos, self.dec_norm)
        causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=dev))
        self_bias = torch.where(
            causal[None, None] & (dec_mask[:, None, None, :] > 0),
            torch.tensor(0.0, device=dev), torch.tensor(NEG, device=dev))
        cross_bias = key_bias(enc_mask)
        for layer in self.dec_layers:
            x = layer(x, enc_hidden, self_bias, cross_bias, generator)
        table = self.shared_embed.weight.to(x.dtype)
        return torch.matmul(x.float(), table.float().T)

    def forward(self, enc_ids, enc_mask, dec_ids, dec_mask, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        enc = self.encode(enc_ids, enc_mask, generator=generator)
        return self.decode(dec_ids, dec_mask, enc, enc_mask,
                           generator=generator)


def seq2seq_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy over ``mask == 1`` target positions."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    m = mask.float()
    return (nll * m).sum() / torch.clamp_min(m.sum(), 1.0)


def sample_top_k(logits: torch.Tensor, top_k: int, gen: torch.Generator,
                 temperature: float = 1.0) -> torch.Tensor:
    """One token a row: the logits at least the row's k-th largest are kept
    (ties keep more than k), the rest set to -1e9, the result divided by
    ``temperature`` and sampled by its softmax."""
    kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
    filtered = torch.where(logits >= kth, logits,
                           torch.tensor(NEG, device=logits.device))
    probs = torch.softmax(filtered / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


@torch.no_grad()
def generate(model: Seq2Seq, enc_ids, enc_mask, rng_seed: int = 0, *,
             max_length: Optional[int] = None, top_k: int = 10,
             temperature: float = 1.0,
             num_return_sequences: int = 1) -> torch.Tensor:
    """Top-k sampling decode (the reference's ``do_sample=True,
    top_k=10``) on the model's device. Returns ``[B, N, max_length]``
    int32 with BOS first and PAD after EOS; ``top_k=1`` is greedy. Each
    row is repeated N times (``jnp.repeat`` order) and encoded."""
    cfg = model.cfg
    dev = model.shared_embed.weight.device
    t_max = max_length or cfg.max_target_length
    n = num_return_sequences
    enc_ids = torch.as_tensor(np.asarray(enc_ids), device=dev)
    enc_mask = torch.as_tensor(np.asarray(enc_mask), device=dev)
    b = enc_ids.shape[0]
    enc_mask = enc_mask.repeat_interleave(n, dim=0)
    enc_hidden = model.encode(enc_ids.repeat_interleave(n, dim=0), enc_mask)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng_seed))
    tokens = torch.full((b * n, t_max), cfg.pad_id, dtype=torch.int32,
                        device=dev)
    tokens[:, 0] = cfg.bos_id
    done = torch.zeros(b * n, dtype=torch.bool, device=dev)
    positions = torch.arange(t_max, device=dev)[None]
    for t in range(t_max - 1):
        dec_mask = (positions <= t).to(torch.int32).expand(b * n, t_max)
        logits = model.decode(tokens, dec_mask, enc_hidden, enc_mask)[:, t]
        nxt = sample_top_k(logits, top_k, gen, temperature).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, cfg.pad_id), nxt)
        tokens[:, t + 1] = nxt
        done = done | (nxt == cfg.eos_id)
    return tokens.reshape(b, n, t_max)


def queries_to_tsv(path: str, passage_ids, query_lists) -> None:
    """The reference's ``query.tsv`` (``generate_query.py:208-214``): one
    row per passage, ``psg_id\\tq1\\t...\\tqN``, each query's whitespace
    collapsed."""
    with open(path, "w", encoding="utf-8") as f:
        for pid, qs in zip(passage_ids, query_lists):
            clean = [" ".join(str(q).split()) for q in qs]
            f.write("\t".join([str(pid)] + clean) + "\n")

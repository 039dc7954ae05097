"""MASTER multi-task masking collator (port of
``simxns_tpu/data/collator.py``; the port keeps its own copy).

Host-side ``CondenserCollator`` (``MASTER/pretrain/data.py:11-451``): from
one pre-tokenized example ``{"text": [ids], "queries": [[ids],...],
"next": [[ids]]}`` it emits 8 parallel (input_ids, labels[, mask]) streams:

1. encoder MLM: whole-word mask at ``mlm_probability``;
2. c_head decoder: keyword-weighted whole-word mask at
   ``decoder_mlm_probability`` (word weight 1/freq, ``data.py:171-219``);
3. query decoder: docT5 queries joined by [SEP], whole-word 50%;
4. gpt decoder: the GPT-2 continuation (or the text if empty), 50%;
5. next encoder: the text's first half, whole-word ``mlm_probability``;
6. next decoder: the second half, keyword-weighted 50%;
7. overlap encoder: one side of a 50/50 complementary word split;
8. overlap decoder: the complement (``_whole_word_mask_dual`` :104-136).

Corruption follows HF ``torch_mask_tokens``: of the masked positions 80%
become [MASK], 10% a random token, 10% stay; labels are -100 elsewhere.
Random truncation keeps a uniformly placed window (``_truncate``
:221-236).

Two paths, each bitwise the JAX package's from the same seed and examples
(numpy and C++ on both sides): the numpy path (always available) and the
batched native path (``native/fast_collator.cc`` through
:mod:`simxns_tpu_torch.data.native`: one C call per stream and batch, rows
on a thread pool), taken when the library builds. :attr:`CondenserCollator.
path` says which one a collator takes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

IGNORE_INDEX = -100


@dataclasses.dataclass
class TokenMeta:
    """Tokenizer facts the collator needs (id-level only).

    ``*_table`` vocab-sized lookup arrays are optional but make the hot path
    vectorized (one fancy-index instead of a Python call per token); the
    factory builds them.
    """
    vocab_size: int
    cls_id: int
    sep_id: int
    pad_id: int
    mask_id: int
    is_special: Callable[[int], bool]
    is_continuation: Callable[[int], bool] = lambda tid: False
    word_weight: Callable[[int], float] = lambda tid: 1.0   # 1/freq for keyword
    special_table: Optional[np.ndarray] = None      # uint8 [V]
    contin_table: Optional[np.ndarray] = None       # uint8 [V]
    weight_table: Optional[np.ndarray] = None       # float64 [V]

    def build_tables(self) -> "TokenMeta":
        v = self.vocab_size
        ids = range(v)
        self.special_table = np.fromiter(
            (self.is_special(i) for i in ids), np.uint8, v)
        self.contin_table = np.fromiter(
            (self.is_continuation(i) for i in ids), np.uint8, v)
        self.weight_table = np.fromiter(
            (self.word_weight(i) for i in ids), np.float64, v)
        return self

    @staticmethod
    def for_hash_tokenizer(tok, mask_id: Optional[int] = None,
                           frequency: Optional[Dict[int, float]] = None
                           ) -> "TokenMeta":
        specials = {tok.pad_token_id, tok.cls_token_id, tok.sep_token_id,
                    tok.unk_token_id}
        freq = frequency or {}
        return TokenMeta(
            vocab_size=tok.vocab_size, cls_id=tok.cls_token_id,
            sep_id=tok.sep_token_id, pad_id=tok.pad_token_id,
            mask_id=mask_id if mask_id is not None else tok.vocab_size - 1,
            is_special=lambda tid: tid in specials,
            word_weight=lambda tid: 1.0 / freq.get(tid, 1.0),
        ).build_tables()


@dataclasses.dataclass
class CondenserCollator:
    meta: TokenMeta
    max_seq_length: int = 128
    mlm_probability: float = 0.30
    decoder_mlm_probability: float = 0.50
    seed: int = 0
    use_native: bool = True      # C++ fast path when the library builds

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self._native = None
        if self.use_native:
            from simxns_tpu_torch.data import native

            if native.available():
                self._native = native

    @property
    def path(self) -> str:
        """``"native"`` when batches take the C++ core, else ``"numpy"``."""
        meta = self.meta
        return ("native" if self._native is not None
                and meta.special_table is not None
                and meta.contin_table is not None
                and meta.weight_table is not None else "numpy")

    # --- native-path helpers ----------------------------------------------
    def _token_flags(self, ids: Sequence[int]):
        arr = np.asarray(ids, np.int32)
        if self.meta.special_table is not None:
            return (arr, self.meta.special_table[arr],
                    self.meta.contin_table[arr])
        special = np.fromiter((self.meta.is_special(int(t)) for t in arr),
                              np.uint8, len(arr))
        contin = np.fromiter((self.meta.is_continuation(int(t)) for t in arr),
                             np.uint8, len(arr))
        return arr, special, contin

    def _seed(self) -> int:
        return int(self.rng.integers(0, 2 ** 63 - 1))

    # --- word grouping ---------------------------------------------------
    def _word_groups(self, ids: Sequence[int]) -> List[List[int]]:
        groups: List[List[int]] = []
        for i, tid in enumerate(ids):
            if self.meta.is_special(tid):
                continue
            if groups and self.meta.is_continuation(tid):
                groups[-1].append(i)
            else:
                groups.append([i])
        return groups

    def _mask_from_groups(self, n: int, groups: List[List[int]],
                          num_to_predict: int) -> np.ndarray:
        mask = np.zeros(n, np.int8)
        taken = 0
        for g in groups:
            if taken >= num_to_predict:
                break
            if taken + len(g) > num_to_predict:
                continue
            mask[g] = 1
            taken += len(g)
        return mask

    def whole_word_mask(self, ids: Sequence[int],
                        probability: Optional[float] = None) -> np.ndarray:
        """0/1 word-mask over ids (``_whole_word_mask`` data.py:71-102)."""
        p = self.mlm_probability if probability is None else probability
        if self._native is not None:
            arr, special, contin = self._token_flags(ids)
            return self._native.whole_word_mask(arr, special, contin, p,
                                                self._seed())
        groups = self._word_groups(ids)
        self.rng.shuffle(groups)
        num = min(512, max(1, int(round(len(ids) * p))))
        return self._mask_from_groups(len(ids), groups, num)

    def keyword_mask(self, ids: Sequence[int]) -> np.ndarray:
        """Keyword-weighted decoder mask (``data.py:171-219``): words drawn
        with probability proportional to 1/corpus-frequency."""
        if self._native is not None:
            arr, special, contin = self._token_flags(ids)
            if self.meta.weight_table is not None:
                weights = self.meta.weight_table[arr]
            else:
                weights = np.fromiter(
                    (self.meta.word_weight(int(t)) for t in arr),
                    np.float64, len(arr))
            return self._native.keyword_mask(
                arr, special, contin, weights,
                self.decoder_mlm_probability, self._seed())
        groups = self._word_groups(ids)
        if not groups:
            return np.zeros(len(ids), np.int8)
        weights = np.array([self.meta.word_weight(ids[g[0]]) for g in groups],
                           np.float64)
        n_real = sum(1 for t in ids if not self.meta.is_special(t))
        num = min(512, max(1, int(round(n_real * self.decoder_mlm_probability))))
        mask = np.zeros(len(ids), np.int8)
        taken = 0
        alive = np.ones(len(groups), bool)
        while taken < num and alive.any():
            p = weights * alive
            p = p / p.sum()
            draws = self.rng.choice(len(groups), size=10, replace=True, p=p)
            for gi in draws:
                if taken >= num:
                    break
                if not alive[gi]:
                    continue
                g = groups[gi]
                mask[g] = 1
                taken += len(g)
                alive[gi] = False
        return mask

    def dual_mask(self, ids: Sequence[int]):
        """50/50 complementary word masks (``_whole_word_mask_dual``)."""
        m = self.whole_word_mask(ids, probability=0.5)
        dual = np.where(m == 1, 0, 1).astype(np.int8)
        # reference's dual mask marks every non-covered index incl. specials;
        # corruption never applies to specials anyway because mask_tokens
        # receives mask labels built before [CLS] prepend + padding.
        return m, dual

    # --- packing ----------------------------------------------------------
    def truncate(self, ids: Sequence[int]) -> List[int]:
        tgt = self.max_seq_length - 2          # room for [CLS], [SEP]
        ids = list(ids)
        if len(ids) <= tgt:
            return ids
        trunc = len(ids) - tgt
        left = int(self.rng.integers(0, trunc + 1))
        right = trunc - left
        return ids[left: len(ids) - right]

    def _encode(self, ids: Sequence[int]) -> np.ndarray:
        out = [self.meta.cls_id] + list(ids) + [self.meta.sep_id]
        out = out[: self.max_seq_length]
        out += [self.meta.pad_id] * (self.max_seq_length - len(out))
        return np.asarray(out, np.int32)

    def _pad_mask(self, word_mask: np.ndarray) -> np.ndarray:
        # preallocated write — np.pad/concatenate dominated the collator
        # profile (43% of wall) at pretrain batch sizes
        m = np.zeros(self.max_seq_length, np.int8)
        n = min(len(word_mask), self.max_seq_length - 1)
        m[1: 1 + n] = word_mask[:n]
        return m

    def mask_tokens(self, inputs: np.ndarray, mask_labels: np.ndarray):
        """HF ``torch_mask_tokens``: 80% [MASK] / 10% random / 10% keep."""
        if self._native is not None:
            return self._native.mask_tokens(
                inputs, mask_labels, self.meta.mask_id,
                self.meta.vocab_size, self._seed())
        labels = np.where(mask_labels == 1, inputs, IGNORE_INDEX).astype(np.int64)
        out = inputs.copy()
        masked = mask_labels == 1
        r = self.rng.random(inputs.shape)
        replace_mask = masked & (r < 0.8)
        random_tok = masked & (r >= 0.8) & (r < 0.9)
        out[replace_mask] = self.meta.mask_id
        out[random_tok] = self.rng.integers(
            0, self.meta.vocab_size, size=int(random_tok.sum()))
        return out.astype(np.int32), labels

    # --- batched native path ----------------------------------------------
    def _raw_streams(self, examples: Sequence[Dict]):
        """Per-example truncation/assembly (cheap Python): the 7 raw
        token-lists every mask stream draws from."""
        texts, queries, gpts, firsts, seconds = [], [], [], [], []
        for e in examples:
            text = self.truncate(e["text"])
            texts.append(text)
            long_query: List[int] = []
            for qry in e.get("queries", []):
                long_query.extend(list(qry) + [self.meta.sep_id])
            queries.append(self.truncate(long_query) if long_query
                           else list(text))
            nxt = e.get("next") or [[]]
            gpts.append(self.truncate(nxt[0]) if nxt[0] else list(text))
            half = len(text) // 2
            firsts.append(text[:half])
            seconds.append(text[half:])
        return texts, queries, gpts, firsts, seconds

    def _pack(self, rows: List[List[int]]):
        """Ragged rows -> ([B, stride] int32 padded with pad_id, lens)."""
        b = len(rows)
        lens = np.fromiter((len(r) for r in rows), np.int32, b)
        stride = max(1, int(lens.max()) if b else 1)
        m = np.full((b, stride), self.meta.pad_id, np.int32)
        for i, r in enumerate(rows):
            m[i, : lens[i]] = r
        return m, lens

    def _encode_batch(self, m: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Vectorized ``_encode``: [CLS] + row + [SEP] + pad, [B, S]."""
        b, stride = m.shape
        s = self.max_seq_length
        out = np.full((b, s), self.meta.pad_id, np.int32)
        out[:, 0] = self.meta.cls_id
        w = min(stride, s - 1)
        cols = np.arange(w)[None, :]
        out[:, 1: 1 + w] = np.where(cols < lens[:, None], m[:, :w],
                                    self.meta.pad_id)
        out[np.arange(b), np.minimum(1 + lens, s - 1)] = self.meta.sep_id
        return out

    def _place_masks(self, wm: np.ndarray) -> np.ndarray:
        """Vectorized ``_pad_mask``: shift word-masks past [CLS]."""
        b, stride = wm.shape
        out = np.zeros((b, self.max_seq_length), np.int8)
        w = min(stride, self.max_seq_length - 1)
        out[:, 1: 1 + w] = wm[:, :w]
        return out

    def _seeds(self, n: int) -> np.ndarray:
        return self.rng.integers(0, 2 ** 63 - 1, size=n, dtype=np.uint64)

    def _call_batched(self, examples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        """One native call per (stream, batch): the per-call ctypes overhead
        was ~60% of wall at batch 512 (see native/fast_collator.cc)."""
        nat, meta = self._native, self.meta
        texts, queries, gpts, firsts, seconds = self._raw_streams(examples)

        packed = {name: self._pack(rows) for name, rows in
                  (("text", texts), ("query", queries), ("gpt", gpts),
                   ("first", firsts), ("second", seconds))}
        flags = {name: (meta.special_table[m], meta.contin_table[m])
                 for name, (m, _) in packed.items()}

        def www(name, prob):
            m, lens = packed[name]
            sp, co = flags[name]
            return nat.whole_word_mask_batch(m, lens, sp, co, prob,
                                             self._seeds(len(lens)))

        def kw(name):
            m, lens = packed[name]
            sp, co = flags[name]
            return nat.keyword_mask_batch(
                m, lens, sp, co, meta.weight_table[m],
                self.decoder_mlm_probability, self._seeds(len(lens)))

        wm = {
            "mlm": www("text", self.mlm_probability),
            "decoder": kw("text"),
            "query": www("query", self.decoder_mlm_probability),
            "gpt": www("gpt", self.decoder_mlm_probability),
            "next_enc": www("first", self.mlm_probability),
            "next_dec": kw("second"),
        }
        m_text, l_text = packed["text"]
        sp, co = flags["text"]
        wm["overlap_enc"], wm["overlap_dec"] = nat.dual_mask_batch(
            m_text, l_text, sp, co, self._seeds(len(l_text)))

        enc = {name: self._encode_batch(*packed[name])
               for name in ("text", "query", "gpt", "first", "second")}
        placed = {k: self._place_masks(v) for k, v in wm.items()}

        def corrupt(ids, mask):
            return nat.mask_tokens_batch(ids, mask, meta.mask_id,
                                         meta.vocab_size,
                                         self._seeds(ids.shape[0]))

        inputs, labels = corrupt(enc["text"], placed["mlm"])
        dec_in, dec_lab = corrupt(enc["text"], placed["decoder"])
        q_in, q_lab = corrupt(enc["query"], placed["query"])
        g_in, g_lab = corrupt(enc["gpt"], placed["gpt"])
        ne_in, ne_lab = corrupt(enc["first"], placed["next_enc"])
        nd_in, nd_lab = corrupt(enc["second"], placed["next_dec"])
        oe_in, oe_lab = corrupt(enc["text"], placed["overlap_enc"])
        od_in, od_lab = corrupt(enc["text"], placed["overlap_dec"])
        pad = meta.pad_id

        return {
            "input_ids": inputs, "labels": labels,
            "decoder_input_ids": dec_in, "decoder_labels": dec_lab,
            "query_input_ids": q_in, "query_labels": q_lab,
            "gpt_input_ids": g_in, "gpt_labels": g_lab,
            "next_encoder_input_ids": ne_in, "next_encoder_labels": ne_lab,
            "next_decoder_input_ids": nd_in, "next_decoder_labels": nd_lab,
            "overlap_encoder_input_ids": oe_in,
            "overlap_encoder_labels": oe_lab,
            "overlap_decoder_input_ids": od_in,
            "overlap_decoder_labels": od_lab,
            "attention_mask": (enc["text"] != pad).astype(np.int32),
            "query_attention_mask": (enc["query"] != pad).astype(np.int32),
            "gpt_attention_mask": (enc["gpt"] != pad).astype(np.int32),
            "next_encoder_attention_mask":
                (enc["first"] != pad).astype(np.int32),
            "next_decoder_attention_mask":
                (enc["second"] != pad).astype(np.int32),
        }

    def __call__(self, examples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        # the batched native path dereferences all three id->flag tables;
        # a hand-built TokenMeta may carry only special_table
        if self.path == "native":
            return self._call_batched(examples)
        streams = {k: [] for k in (
            "text", "query", "gpt", "next_enc", "next_dec")}
        word_masks = {k: [] for k in (
            "mlm", "decoder", "query", "gpt", "next_enc", "next_dec",
            "overlap_enc", "overlap_dec")}

        for e in examples:
            text = self.truncate(e["text"])
            streams["text"].append(self._encode(text))
            word_masks["mlm"].append(self._pad_mask(self.whole_word_mask(text)))
            word_masks["decoder"].append(self._pad_mask(self.keyword_mask(text)))

            long_query: List[int] = []
            for qry in e.get("queries", []):
                long_query.extend(list(qry) + [self.meta.sep_id])
            long_query = self.truncate(long_query) if long_query else list(text)
            streams["query"].append(self._encode(long_query))
            word_masks["query"].append(self._pad_mask(
                self.whole_word_mask(long_query,
                                     self.decoder_mlm_probability)))

            nxt = e.get("next") or [[]]
            gpt = self.truncate(nxt[0]) if nxt[0] else list(text)
            streams["gpt"].append(self._encode(gpt))
            word_masks["gpt"].append(self._pad_mask(
                self.whole_word_mask(gpt, self.decoder_mlm_probability)))

            half = len(text) // 2
            first, second = text[:half], text[half:]
            streams["next_enc"].append(self._encode(first))
            word_masks["next_enc"].append(self._pad_mask(
                self.whole_word_mask(first)))
            streams["next_dec"].append(self._encode(second))
            word_masks["next_dec"].append(self._pad_mask(
                self.keyword_mask(second)))

            enc_m, dec_m = self.dual_mask(text)
            word_masks["overlap_enc"].append(self._pad_mask(enc_m))
            word_masks["overlap_dec"].append(self._pad_mask(dec_m))

        arr = {k: np.stack(v) for k, v in streams.items()}
        wm = {k: np.stack(v) for k, v in word_masks.items()}
        pad = self.meta.pad_id

        def corrupt(ids, mask):
            return self.mask_tokens(ids, mask)

        inputs, labels = corrupt(arr["text"], wm["mlm"])
        dec_in, dec_lab = corrupt(arr["text"], wm["decoder"])
        q_in, q_lab = corrupt(arr["query"], wm["query"])
        g_in, g_lab = corrupt(arr["gpt"], wm["gpt"])
        ne_in, ne_lab = corrupt(arr["next_enc"], wm["next_enc"])
        nd_in, nd_lab = corrupt(arr["next_dec"], wm["next_dec"])
        oe_in, oe_lab = corrupt(arr["text"], wm["overlap_enc"])
        od_in, od_lab = corrupt(arr["text"], wm["overlap_dec"])

        return {
            "input_ids": inputs, "labels": labels,
            "decoder_input_ids": dec_in, "decoder_labels": dec_lab,
            "query_input_ids": q_in, "query_labels": q_lab,
            "gpt_input_ids": g_in, "gpt_labels": g_lab,
            "next_encoder_input_ids": ne_in, "next_encoder_labels": ne_lab,
            "next_decoder_input_ids": nd_in, "next_decoder_labels": nd_lab,
            "overlap_encoder_input_ids": oe_in,
            "overlap_encoder_labels": oe_lab,
            "overlap_decoder_input_ids": od_in,
            "overlap_decoder_labels": od_lab,
            "attention_mask": (arr["text"] != pad).astype(np.int32),
            "query_attention_mask": (arr["query"] != pad).astype(np.int32),
            "gpt_attention_mask": (arr["gpt"] != pad).astype(np.int32),
            "next_encoder_attention_mask":
                (arr["next_enc"] != pad).astype(np.int32),
            "next_decoder_attention_mask":
                (arr["next_dec"] != pad).astype(np.int32),
        }

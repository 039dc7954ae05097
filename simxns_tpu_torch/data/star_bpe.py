"""Pinned Roberta byte-level-BPE tokenizer, the STAR tokenizer contract
(own copy of ``simxns_tpu/data/star_bpe.py``).

The reference vendors transformers-2.8's ``RobertaTokenizer``
(``SimANS/Doc_training/star_tokenizer.py``) because later versions encode
differently, and MS-Doc reproduction depends on the 2.8 behaviour:

- GPT-2 byte-level BPE: the byte->unicode map, the GPT-2 split regex, the
  greedy lowest-rank merge loop (``star_tokenizer.py:2655-2721``);
- Roberta specials: ``<s> X </s>``, pairs ``<s> A </s></s> B </s>``;
- ``encode()`` prepends one space when the text does not start with
  whitespace (2.8's ``add_prefix_space`` follows ``add_special_tokens``);
- 2.8's ``longest_first`` truncation: one token at a time from the longer
  segment, the pair segment on ties;
- ``do_lower_case`` is accepted and ignored, as 2.8's GPT-2 tokenizer did.

Pure host code; ``regex`` (for ``\\p{L}`` and ``\\p{N}``) is imported at
the first tokenization.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Optional, Tuple



@functools.lru_cache()
def _gpt2_split():
    """GPT-2's split pattern (``regex``, imported here: only a tokenizer
    needs it, and the card's machine has no ``regex``)."""
    import regex

    return regex.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"""
        r"""|\s+(?!\S)|\s+""")


@functools.lru_cache()
def _byte_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte->printable-unicode map: printable latin bytes
    map to themselves, the rest to 256+offset codepoints."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    mapping = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


class StarRobertaTokenizer:
    """The vendored STAR tokenizer's ``encode`` surface, and the port's
    :class:`simxns_tpu_torch.data.tokenization.Tokenizer` protocol."""

    def __init__(self, vocab_file: str, merges_file: str,
                 errors: str = "replace", **ignored_kwargs):
        # **ignored_kwargs swallows do_lower_case etc., as 2.8 did
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")[1:-1]
        self.bpe_ranks: Dict[Tuple[str, str], int] = {
            tuple(line.split()): rank for rank, line in enumerate(lines)}
        self.errors = errors
        self.byte_encoder = _byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, Tuple[str, ...]] = {}
        self.bos_token, self.eos_token = "<s>", "</s>"
        self.cls_token_id = self.encoder["<s>"]
        self.sep_token_id = self.encoder["</s>"]
        self.pad_token_id = self.encoder.get("<pad>", 1)
        self.unk_token = "<unk>"
        self.unk_token_id = self.encoder.get("<unk>", 3)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    # --- BPE core -----------------------------------------------------

    def _merge(self, piece: str) -> Tuple[str, ...]:
        if piece in self._cache:
            return self._cache[piece]
        symbols: List[str] = list(piece)
        while len(symbols) > 1:
            ranked = [(self.bpe_ranks.get((a, b), None), i)
                      for i, (a, b) in enumerate(zip(symbols, symbols[1:]))]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            best_rank = min(ranked)[0]
            first, second = None, None
            for r, i in ranked:
                if r == best_rank:
                    first, second = symbols[i], symbols[i + 1]
                    break
            # merge every (first, second) occurrence left-to-right
            out: List[str] = []
            i = 0
            while i < len(symbols):
                if (i + 1 < len(symbols) and symbols[i] == first
                        and symbols[i + 1] == second):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            symbols = out
        result = tuple(symbols)
        self._cache[piece] = result
        return result

    def tokenize(self, text: str, add_prefix_space: bool = False) -> List[str]:
        if add_prefix_space and text and not text[0].isspace():
            text = " " + text
        tokens: List[str] = []
        for chunk in _gpt2_split().findall(text):
            mapped = "".join(self.byte_encoder[b]
                             for b in chunk.encode("utf-8"))
            tokens.extend(self._merge(mapped))
        return tokens

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self.encoder.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.decoder.get(i, self.unk_token) for i in ids]

    def decode(self, ids: List[int], skip_special_tokens: bool = True) -> str:
        specials = {self.cls_token_id, self.sep_token_id, self.pad_token_id}
        toks = [self.decoder.get(i, self.unk_token) for i in ids
                if not (skip_special_tokens and i in specials)]
        raw = "".join(toks)
        return bytearray(self.byte_decoder[c] for c in raw).decode(
            "utf-8", errors=self.errors)

    # --- encode (the call sites' contract) -----------------------------

    def encode(self, text: str, text_pair: Optional[str] = None,
               max_length: Optional[int] = None,
               add_special_tokens: bool = True,
               padding: bool = False) -> List[int]:
        """2.8's ``tokenizer.encode(text, add_special_tokens=True,
        max_length=L, truncation=True, padding='max_length')``
        (``co_training_generate_new_train.py:54-56,101-103``) as a list of
        ids; ``padding=False`` (the collators pad downstream)."""
        ids = self.convert_tokens_to_ids(
            self.tokenize(text, add_prefix_space=add_special_tokens))
        pair_ids = (self.convert_tokens_to_ids(
            self.tokenize(text_pair, add_prefix_space=add_special_tokens))
            if text_pair is not None else None)
        n_special = (0 if not add_special_tokens
                     else (2 if pair_ids is None else 4))
        if max_length is not None:
            total = len(ids) + (len(pair_ids) if pair_ids else 0) + n_special
            for _ in range(max(0, total - max_length)):
                if pair_ids is None or len(ids) > len(pair_ids):
                    ids = ids[:-1]
                else:
                    pair_ids = pair_ids[:-1]
        if add_special_tokens:
            cls, sep = [self.cls_token_id], [self.sep_token_id]
            out = (cls + ids + sep if pair_ids is None
                   else cls + ids + sep + sep + pair_ids + sep)
        else:
            out = ids + (pair_ids or [])
        if padding and max_length is not None and len(out) < max_length:
            out = out + [self.pad_token_id] * (max_length - len(out))
        return out


def load_star_tokenizer(vocab_file: str, merges_file: str,
                        **kwargs) -> StarRobertaTokenizer:
    """Build the pinned MS-Doc tokenizer from local roberta-base
    ``vocab.json``/``merges.txt`` files."""
    return StarRobertaTokenizer(vocab_file, merges_file, **kwargs)

"""Host-side tokenization (own copy of ``simxns_tpu.data.tokenization``).

:class:`HashTokenizer` gives the same ids as the JAX package's: a
deterministic hash vocabulary over a whitespace+punctuation split, with
BERT's conventions (``[CLS] a [SEP]``, pairs ``[CLS] a [SEP] b [SEP]``,
pad id 0). :func:`load_hf_tokenizer` wraps a HF fast tokenizer saved on
local disk (``transformers`` is imported at the call, offline);
:func:`pack_joint` builds a cross-encoder row from a question and a
passage's ids.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Optional, Protocol, Sequence


class Tokenizer(Protocol):
    pad_token_id: int
    cls_token_id: int
    sep_token_id: int

    def encode(self, text: str, text_pair: Optional[str] = None,
               max_length: Optional[int] = None) -> List[int]: ...


class HashTokenizer:
    """Deterministic vocab-free tokenizer: token -> stable hash bucket.

    ids 0..3 are reserved: pad=0, cls=1, sep=2, unk=3.
    """

    def __init__(self, vocab_size: int = 30522, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        self.pad_token_id = 0
        self.cls_token_id = 1
        self.sep_token_id = 2
        self.unk_token_id = 3
        self._word_re = re.compile(r"\w+|[^\w\s]", re.UNICODE)

    def _token_id(self, tok: str) -> int:
        h = int.from_bytes(hashlib.md5(tok.encode("utf-8")).digest()[:4],
                           "little")
        return 4 + h % (self.vocab_size - 4)

    def tokenize(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        return self._word_re.findall(text)

    def encode(self, text: str, text_pair: Optional[str] = None,
               max_length: Optional[int] = None) -> List[int]:
        ids = [self.cls_token_id]
        ids += [self._token_id(t) for t in self.tokenize(text or "")]
        ids.append(self.sep_token_id)
        if text_pair is not None:
            ids += [self._token_id(t) for t in self.tokenize(text_pair)]
            ids.append(self.sep_token_id)
        if max_length is not None and len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_token_id]
        return ids


def load_hf_tokenizer(name_or_path: str):
    """Load a HF fast tokenizer from a local path (offline: the hub is
    never asked)."""
    import os

    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(name_or_path)

    class _Wrap:
        pad_token_id = tok.pad_token_id or 0
        cls_token_id = tok.cls_token_id
        sep_token_id = tok.sep_token_id

        @staticmethod
        def encode(text, text_pair=None, max_length=None):
            return tok.encode(text, text_pair=text_pair, max_length=max_length,
                              truncation=max_length is not None,
                              add_special_tokens=True)

        @staticmethod
        def encode_batch(texts, pairs=None, max_length=None):
            """The fast tokenizer's batch encoding (its threads take the
            rows)."""
            out = tok(list(texts), text_pair=list(pairs) if pairs else None,
                      max_length=max_length,
                      truncation=max_length is not None,
                      add_special_tokens=True)
            return out["input_ids"]

    return _Wrap()


def pack_joint(question_ids: Sequence[int], ctx_ids: Sequence[int],
               sep_token_id: int, max_length: int) -> List[int]:
    """Cross-encoder input: the question's ids, then the passage's content
    tokens (its leading CLS and its trailing SEP stripped), cut to
    ``max_length`` with no SEP re-added."""
    ctx = list(ctx_ids)
    if ctx and ctx[0] != sep_token_id:
        ctx = ctx[1:]
    if ctx and ctx[-1] == sep_token_id:
        ctx = ctx[:-1]
    joint = list(question_ids) + ctx
    return joint[:max_length]


def pad_to(ids: Sequence[int], length: int, pad_id: int = 0) -> List[int]:
    out = list(ids)[:length]
    return out + [pad_id] * (length - len(out))

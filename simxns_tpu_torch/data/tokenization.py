"""Host-side tokenization (own copy of ``simxns_tpu.data.tokenization``).

:class:`HashTokenizer` gives the same ids as the JAX package's: a
deterministic hash vocabulary over a whitespace+punctuation split, with
BERT's conventions (``[CLS] a [SEP]``, pairs ``[CLS] a [SEP] b [SEP]``,
pad id 0).
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


def pad_to(ids: Sequence[int], length: int, pad_id: int = 0) -> List[int]:
    out = list(ids)[:length]
    return out + [pad_id] * (length - len(out))

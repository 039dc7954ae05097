"""The port's pinned Roberta BPE (``simxns_tpu_torch.data.star_bpe``)
against the JAX package's (``simxns_tpu.data.star_bpe``) on a vocabulary
and merges written here (every byte symbol, the specials, 20 merges, one
vocabulary without ``<unk>`` entries for some bytes): tokens, ids,
truncation, pairs, unknowns, padding and decoding equal, token for token
(pure host code on both sides: no tolerance)."""

import json

import pytest

from simxns_tpu.data import star_bpe as jbpe
from simxns_tpu_torch.data import star_bpe as pbpe
from torch_parity import one_torch_thread  # noqa: F401

MERGES = [
    ("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("a", "n"), ("an", "d"),
    ("e", "r"), ("Ġ", "a"), ("i", "n"), ("o", "u"), ("r", "e"),
    ("Ġa", "nd"), ("e", "s"), ("o", "n"), ("Ġ", "s"), ("in", "g"),
    ("'", "s"), ("1", "2"), ("12", "3"), (".", "."), ("!", "!"),
]

TEXTS = [
    "the cat sat on the mat",
    "Hello, World!  Multiple   spaces\tand\ttabs\nnewlines",
    "it's the user's cat'll don't",
    "numbers 123 456789 3.14 and 12,000",
    "punctuation!!! ... ??? ---",
    "unicode café naïve 北京 åæø é",
    "emoji 🙂 and symbols © ® ±",
    " leading space",
    "trailing space ",
    "MixedCASE Words And CAPS",
    "a",
    "",
    "supercalifragilisticexpialidocious antidisestablishmentarianism",
]


def _write(d, drop=()):
    """vocab.json and merges.txt; ``drop``: byte symbols left out of the
    vocabulary (they map to <unk>)."""
    tokens = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
    tokens += [t for t in pbpe._byte_to_unicode().values() if t not in drop]
    tokens += [a + b for a, b in MERGES]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    vp, mp = str(d / "vocab.json"), str(d / "merges.txt")
    with open(vp, "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(mp, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in MERGES:
            f.write(f"{a} {b}\n")
    return vp, mp


@pytest.fixture(scope="module", params=["full", "unknowns"])
def pair(request, tmp_path_factory):
    drop = () if request.param == "full" else tuple(
        pbpe._byte_to_unicode()[b] for b in (0xF0, 0x9F, 0xC3, 0xA9, ord("z")))
    vp, mp = _write(tmp_path_factory.mktemp(request.param), drop)
    return (pbpe.load_star_tokenizer(vp, mp, do_lower_case=True),
            jbpe.load_star_tokenizer(vp, mp, do_lower_case=True))


def test_byte_map_is_jax():
    assert pbpe._byte_to_unicode() == jbpe._byte_to_unicode()
    assert len(set(pbpe._byte_to_unicode().values())) == 256


@pytest.mark.parametrize("text", TEXTS)
def test_tokens_and_ids_match_jax(pair, text):
    tok, ref = pair
    for prefix in (False, True):
        assert (tok.tokenize(text, add_prefix_space=prefix)
                == ref.tokenize(text, add_prefix_space=prefix))
    assert tok.encode(text) == ref.encode(text)
    assert (tok.encode(text, add_special_tokens=False)
            == ref.encode(text, add_special_tokens=False))
    ids = tok.encode(text, add_special_tokens=False)
    assert tok.convert_ids_to_tokens(ids) == ref.convert_ids_to_tokens(ids)
    assert tok.decode(ids) == ref.decode(ids)


@pytest.mark.parametrize("max_length", [1, 4, 8, 16, 64])
def test_truncation_pairs_and_padding_match_jax(pair, max_length):
    """2.8's longest_first cut, the pair layout <s> A </s></s> B </s>, and
    padding to max_length."""
    tok, ref = pair
    for a, b in ((TEXTS[0], TEXTS[1]), (TEXTS[3], TEXTS[10]),
                 (TEXTS[5], None)):
        for padding in (False, True):
            got = tok.encode(a, text_pair=b, max_length=max_length,
                             padding=padding)
            assert got == ref.encode(a, text_pair=b, max_length=max_length,
                                     padding=padding)
            if padding and max_length >= (2 if b is None else 4):
                assert len(got) == max_length


def test_specials_unknowns_and_decode(pair):
    tok, ref = pair
    for attr in ("cls_token_id", "sep_token_id", "pad_token_id",
                 "unk_token_id", "vocab_size"):
        assert getattr(tok, attr) == getattr(ref, attr), attr
    ids = tok.encode("café 🙂 zebra", text_pair="naïve")
    assert ids == ref.encode("café 🙂 zebra", text_pair="naïve")
    assert ids[0] == tok.cls_token_id and ids[-1] == tok.sep_token_id
    for skip in (True, False):
        assert (tok.decode(ids, skip_special_tokens=skip)
                == ref.decode(ids, skip_special_tokens=skip))
    assert tok.convert_tokens_to_ids(["nope"]) == [tok.unk_token_id]

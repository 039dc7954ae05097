"""Hit labeling of the port (no ``regex`` package) against the JAX
package's ``regex`` tokenizer: the same tokens and the same ``has_answer``
on generated Unicode text (combining marks, digits, CJK, ``_``,
punctuation, Z* separators, C* controls), and the reference's quirks."""

import unicodedata

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from simxns_tpu.evals import qa_match as jqa
from simxns_tpu_torch.evals import qa_match as pqa
from simxns_tpu_torch.evals._unicode_ranges import RANGES

# each class the tokenizer must split on exactly as the regex does
_SPECIAL = list(
    "aZ\u00e9_-.,!?'\"()[]$\u20ac\u00a9\u00bf\u2014"
    "\u0301\u0308\u20dd"                  # combining marks (Mn, Me)
    "09\u0663\u00b2\u216b"                 # digits: Nd, No, Nl
    "\u4e2d\u6587\u3042"                   # CJK and kana
    " \u00a0\u2028\u2029\u3000"           # separators Zs, Zl, Zp
    "\n\t\x00\x7f\u200b\ufeff"           # controls and formats (Cc, Cf)
    "\u01c5\u00df\u0130\U0001f600"        # Lt, sharp s, I-dot, emoji
)
# every code point but the surrogates: one unassigned in this Python's
# Unicode tables ("Cn") may be assigned in the regex package's newer ones,
# and the port takes its class from evals/_unicode_ranges.py
_CHARS = st.one_of(st.sampled_from(_SPECIAL),
                   st.sampled_from([chr(r[0]) for r in RANGES]),
                   st.characters(exclude_categories=("Cs",)))
_TEXT = st.text(_CHARS, max_size=40)


@settings(max_examples=600, derandomize=True, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(text=_TEXT, answers=st.lists(_TEXT, max_size=3),
       take=st.tuples(st.integers(0, 40), st.integers(0, 12)))
def test_tokenize_and_has_answer_match_regex(text, answers, take):
    tok_j, tok_p = jqa.SimpleTokenizer(), pqa.SimpleTokenizer()
    for t in (text, unicodedata.normalize("NFD", text)):
        assert tok_p.tokenize(t) == tok_j.tokenize(t)
        assert tok_p.words(t) == tok_j.words(t)
    # an answer cut from the text itself, so that matches happen
    start, length = take
    answers = answers + [text[start: start + length]]
    assert pqa.has_answer(answers, text) == jqa.has_answer(answers, text)
    assert (pqa.check_answer(answers, [text, text.upper()])
            == jqa.check_answer(answers, [text, text.upper()]))


def test_quirks_and_regex_mode():
    # an answer that tokenizes to [] matches every passage
    for answers in ([""], ["  "], ["\u200b"]):
        assert pqa.has_answer(answers, "anything") is True
        assert jqa.has_answer(answers, "anything") is True
    assert pqa.has_answer(["Café"], "the café opens") is True
    assert pqa.has_answer(["fact1"], "fact12 and fact13") is False
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pqa.has_answer(["a.c"], "abc", match_type="regex")
    with pytest.raises(ValueError):
        pqa.has_answer(["a"], "a", match_type="fuzzy")


@pytest.mark.parametrize("ch", ["\u1ad0", "\u0897", "\U0002ebf0", "\u1b4e",
                                "\U0001fae9", "\u2fff"])
def test_unicode_newer_than_unicodedata_matches_regex(ch):
    """Characters that this Python's unicodedata calls unassigned and the
    regex package assigns (a mark, a letter, CJK Extension I, punctuation,
    symbols): tokens and hits equal the JAX package's."""
    assert unicodedata.category(ch) == "Cn"
    for text in (f"foo{ch}bar", f"the {ch} foo bar", ch):
        assert pqa.SimpleTokenizer().tokenize(text) == \
            jqa.SimpleTokenizer().tokenize(text)
    for answers, text in (([f"foo{ch}bar"], "the foo bar"),
                          ([ch], "the foo bar"), ([ch], f"a {ch} b"),
                          (["foo bar"], f"the foo{ch}bar")):
        assert pqa.has_answer(answers, text) == jqa.has_answer(answers, text)

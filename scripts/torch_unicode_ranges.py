#!/usr/bin/env python3
"""Write ``simxns_tpu_torch/evals/_unicode_ranges.py`` from the ``regex``
package's Unicode tables.

    python scripts/torch_unicode_ranges.py [--check]

The JAX package tokenizes answers and passages with the ``regex`` package
(``simxns_tpu/evals/qa_match.py``), whose Unicode tables are newer than
the ones of Python's ``unicodedata``. The port's hit labeling classes
characters with ``unicodedata.category`` and needs no ``regex`` at run
time, so a character that ``unicodedata`` calls unassigned takes its
class from the table this script writes: the code points that ``unicodedata`` calls unassigned ("Cn") and
``regex`` assigns, as ranges with their major class (L, M, N, P or S).

The script then checks every code point but the surrogates: the port's
class (the table, else ``unicodedata``) must be the class ``regex``
assigns, and a character alone must tokenize as the JAX package's
tokenizer does. ``--check`` compares the committed table with a fresh one
instead of writing it. Run it again when either package's tables change.
"""

import argparse
import sys
import unicodedata
from pathlib import Path

import regex

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "simxns_tpu_torch" / "evals" / "_unicode_ranges.py"
MAJOR = "LMNPSZC"


def regex_major(classes, ch):
    hits = [m for m in MAJOR if classes[m].match(ch)]
    if len(hits) != 1:
        raise AssertionError(f"U+{ord(ch):04X}: regex classes {hits}")
    return hits[0]


def code_points():
    return (cp for cp in range(sys.maxunicode + 1)
            if not 0xD800 <= cp <= 0xDFFF)


def ranges(classes):
    """[(first, last, major)] of the code points unassigned to
    ``unicodedata`` and assigned to ``regex``; fails on any other code
    point whose major class differs."""
    out = []
    for cp in code_points():
        ch = chr(cp)
        ours = unicodedata.category(ch)
        theirs = regex_major(classes, ch)
        if ours[0] == theirs:
            continue
        if ours != "Cn":
            raise AssertionError(f"U+{cp:04X}: unicodedata {ours}, regex "
                                 f"{theirs}: not an unassigned code point")
        if out and out[-1][1] == cp - 1 and out[-1][2] == theirs:
            out[-1] = (out[-1][0], cp, theirs)
        else:
            out.append((cp, cp, theirs))
    return out


def render(table):
    lines = [
        '"""Code points that Python\'s ``unicodedata`` (Unicode '
        f'{unicodedata.unidata_version}) calls',
        'unassigned ("Cn") and the ``regex`` package assigns, with their '
        'major class.',
        "",
        "Generated by ``scripts/torch_unicode_ranges.py`` from regex "
        f"{regex.__version__};",
        "do not edit. ``evals/qa_match.py`` takes the class of a character "
        "from here",
        "where ``unicodedata`` calls it unassigned.",
        '"""',
        "",
        f"UNIDATA_VERSION = {unicodedata.unidata_version!r}",
        "",
        "# (first, last, major class), sorted, not overlapping",
        "RANGES = (",
    ]
    lines += [f"    (0x{a:05X}, 0x{b:05X}, {m!r})," for a, b, m in table]
    lines += [")", ""]
    return "\n".join(lines)


def check_tokenizer():
    """Every code point alone tokenizes as the JAX package's regex does."""
    sys.path.insert(0, str(ROOT))
    from simxns_tpu_torch.evals import qa_match as pqa

    pattern = regex.compile(r"([\p{L}\p{N}\p{M}]+)|([^\p{Z}\p{C}])",
                            flags=regex.IGNORECASE + regex.UNICODE
                            + regex.MULTILINE)
    tok = pqa.SimpleTokenizer()
    bad = [cp for cp in code_points()
           if tok.tokenize(chr(cp) + "a" + chr(cp)) != [
               m.group() for m in pattern.finditer(chr(cp) + "a" + chr(cp))]]
    if bad:
        raise AssertionError(f"{len(bad)} code points tokenize otherwise, "
                             f"first U+{bad[0]:04X}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the committed table, write nothing")
    args = ap.parse_args()
    classes = {m: regex.compile(r"\p{%s}" % m) for m in MAJOR}
    text = render(ranges(classes))
    if args.check:
        if OUT.read_text(encoding="utf-8") != text:
            print(f"{OUT} is stale: run {Path(__file__).name}")
            return 1
    else:
        OUT.write_text(text, encoding="utf-8")
    check_tokenizer()
    n = text.count("\n    (0x")
    print(f"{OUT.relative_to(ROOT)}: {n} ranges; every code point "
          "tokenizes as the regex package does")
    return 0


if __name__ == "__main__":
    sys.exit(main())

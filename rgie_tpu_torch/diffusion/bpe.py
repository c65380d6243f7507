"""CLIP byte-pair-encoding tokenizer, the port's own copy of
``rgie_tpu/diffusion/bpe.py`` (pure Python; loads the standard
bpe_simple_vocab_16e6 merges file when one is provided via
RGIE_CLIP_BPE_PATH). Implements the same algorithm as OpenAI CLIP's
SimpleTokenizer: byte->unicode mapping, lowercased word split, BPE merges
with the '</w>' end-of-word marker.

Word split uses CLIP's exact ``\\p{L}/\\p{N}`` pattern via the `regex`
module when available (it ships with transformers), with a unicode-category
scanner fallback that reproduces the same alternation order and greediness. Text cleaning covers the parts of ftfy.fix_text
that matter for captions — a minimal fix_encoding mojibake repair
(UTF-8-mis-decoded-as-cp1252/latin-1, single and double encoded), html unescape, NFC normalization, curly-quote uncurling,
full-width -> ASCII width folding, control-char removal.
"""

from __future__ import annotations

import gzip
import html
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Tuple


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) +
          list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


try:  # CLIP's exact pattern needs \p classes -> the `regex` module.
    import regex as _regex

    _PAT = _regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", _regex.IGNORECASE)
except ImportError:  # pragma: no cover - regex ships with transformers here
    _PAT = None

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
# Alternation order of the CLIP pattern (first match wins, not longest).
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _cat0(ch: str) -> str:
    return unicodedata.category(ch)[0]


def _word_split_scan(text: str) -> List[str]:
    """Fallback scanner equivalent to the CLIP pattern: specials and
    contractions only match at a scan position (a greedy punctuation run
    engulfs a following special/apostrophe exactly like the regex does);
    \\p{L}/\\p{N} are the unicode L*/N* categories, NOT str.isalpha /
    str.isnumeric (those include Other_Alphabetic / Numeric_Type extras)."""
    tokens: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        special = next((s for s in _SPECIALS if text.startswith(s, i)), None)
        if special:
            tokens.append(special)
            i += len(special)
            continue
        if ch == "'":
            contr = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
            if contr:
                tokens.append(contr)
                i += len(contr)
                continue
        cat = _cat0(ch)
        if cat == "L":
            j = i + 1
            while j < n and _cat0(text[j]) == "L":
                j += 1
            tokens.append(text[i:j])
            i = j
        elif cat == "N":
            tokens.append(ch)
            i += 1
        else:
            j = i + 1
            while (j < n and not text[j].isspace()
                   and _cat0(text[j]) not in ("L", "N")):
                j += 1
            tokens.append(text[i:j])
            i = j
    return tokens


def word_split(text: str) -> List[str]:
    if _PAT is not None:
        return _PAT.findall(text)
    return _word_split_scan(text)


_QUOTE_MAP = str.maketrans({
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"', "‟": '"',
})

# UTF-8 lead bytes of 2-4 byte sequences are 0xC2-0xF4; decoded as
# latin-1/cp1252 they surface as Â..ô. Mojibake therefore always contains
# one of these followed by a continuation-looking char. U+0080-U+00BF is the
# latin-1 view of continuation bytes; the punctuation set is cp1252's view
# of 0x80-0x9F (€‚ƒ„…†‡ˆ‰Š‹ŒŽ''""•–—˜™š›œžŸ).
_MOJIBAKE_LEAD = re.compile(
    "[\u00c2-\u00f4][\u0080-\u00bf\u20ac\u201a\u0192\u201e\u2026\u2020\u2021\u02c6\u2030\u0160\u2039\u0152\u017d\u2018\u2019\u201c\u201d\u2022\u2013\u2014\u02dc\u2122\u0161\u203a\u0153\u017e\u0178]")


def _fix_encoding(text: str) -> str:
    """Minimal ftfy.fix_encoding: repair UTF-8 that was mis-decoded as
    cp1252/latin-1, including the double-encoded case ("ÃƒÂ©" -> "é").

    A repair is accepted only when (a) the text shows a mojibake signature
    (UTF-8 lead byte followed by a continuation-byte rendering), (b) the
    cp1252/latin-1 -> UTF-8 round trip decodes cleanly, and (c) the result
    has fewer non-ASCII chars (multi-byte sequences always collapse), so
    well-formed accented text ("café", "São Paulo") passes through
    untouched. Reference analog: the pip-installed clip runs full
    ftfy.fix_text (`the reference's pyproject.toml:32`)."""
    for _ in range(2):  # two passes undo double-encoded mojibake
        if not _MOJIBAKE_LEAD.search(text):
            break
        repaired = None
        for codec in ("cp1252", "latin-1"):
            try:
                repaired = text.encode(codec).decode("utf-8")
                break
            except (UnicodeEncodeError, UnicodeDecodeError):
                continue
        if repaired is None:
            break
        n_old = sum(ord(c) > 127 for c in text)
        n_new = sum(ord(c) > 127 for c in repaired)
        if n_new >= n_old:
            break
        text = repaired
    return text


def _fix_text_lite(text: str) -> str:
    """The deterministic subset of ftfy.fix_text CLIP applies before
    tokenizing: mojibake repair (minimal fix_encoding, above), html
    unescape, uncurl quotes, fold full-width forms to ASCII, drop control
    characters, NFC-normalize."""
    text = _fix_encoding(text)
    text = html.unescape(text)
    text = text.translate(_QUOTE_MAP)
    # Halfwidth/Fullwidth Forms block + ideographic space -> compatibility
    # forms (ftfy's fix_character_width).
    if any("＀" <= ch <= "￯" or ch == "　" for ch in text):
        text = "".join(
            unicodedata.normalize("NFKC", ch)
            if ("＀" <= ch <= "￯" or ch == "　") else ch
            for ch in text)
    text = "".join(ch for ch in text
                   if ch in "\t\n\r" or unicodedata.category(ch) != "Cc")
    return unicodedata.normalize("NFC", text)


class SimpleBPE:
    def __init__(self, bpe_path: str):
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def __call__(self, text: str) -> List[int]:
        # CLIP: basic_clean (ftfy.fix_text + double html.unescape + strip),
        # whitespace_clean, lower — then the word-split pattern.
        text = html.unescape(html.unescape(_fix_text_lite(text))).strip()
        text = re.sub(r"\s+", " ", text).lower()
        ids: List[int] = []
        for token in word_split(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

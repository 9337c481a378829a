"""Self-contained GPT-2 byte-level BPE tokenizer (vocab.json + merges.txt).

Counterpart of the reference's ``harness/bpe.py``: it makes the CLM
perplexity harness (``tools/clm_eval.py``, GPT-2/OPT/BLOOM-style
vocabularies) and the serving CLI run without ``transformers``. It
implements the GPT-2 scheme exactly: the pre-tokenizer pattern
(re-expressed with unicodedata category scans, since stdlib ``re`` lacks
\\p classes and no ``regex`` package is needed), the printable
byte<->unicode alphabet, and rank-greedy pair merging with a token cache.

The callable API matches the HF one that ``harness/data.py`` uses:
    tok = BPETokenizer(vocab_json, merges_txt)
    tok("text")["input_ids"]
"""

from __future__ import annotations

import json
import unicodedata
from typing import Dict, List, Tuple

__all__ = ["BPETokenizer", "bytes_to_unicode", "pretokenize"]


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode alphabet."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def _is_space(ch: str) -> bool:
    return ch.isspace()


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _class_run(text: str, start: int, j: int) -> str:
    """Token spanning [start, k): a leading-space-optional run of one
    character class (letters / numbers / other-non-space) from ``j``."""
    n = len(text)
    ch = text[j]
    if _is_letter(ch):
        pred = _is_letter
    elif _is_number(ch):
        pred = _is_number
    else:
        pred = lambda c: not (_is_space(c) or _is_letter(c)
                              or _is_number(c))
    k = j + 1
    while k < n and pred(text[k]):
        k += 1
    return text[start:k]


def pretokenize(text: str) -> List[str]:
    """GPT-2 pre-tokenizer: scanner equivalent of the pattern
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|
    \\s+(?!\\S)|\\s+`` (stdlib ``re`` has no \\p classes)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "'":
            hit = next((c for c in _CONTRACTIONS
                        if text.startswith(c, i)), None)
            if hit:
                out.append(hit)
                i += len(hit)
                continue
            # plain apostrophe: the "other" class
            tok = _class_run(text, i, i)
            out.append(tok)
            i += len(tok)
            continue
        if not _is_space(ch):
            tok = _class_run(text, i, i)
            out.append(tok)
            i += len(tok)
            continue
        # whitespace run of length w
        j = i
        while j < n and _is_space(text[j]):
            j += 1
        if j == n:
            out.append(text[i:j])       # trailing: \s+(?!\S) takes all
            i = j
        elif j - i > 1:
            out.append(text[i:j - 1])   # \s+(?!\S): all but the last
            i = j - 1
        elif ch == " ":
            # single space: becomes the ` ?` prefix of the next token
            # (unless the next char starts a contraction — the
            # contraction alternatives have no leading space, so the
            # space joins the "other" run of the apostrophe)
            tok = _class_run(text, i, i + 1)
            out.append(tok)
            i += len(tok)
        else:
            out.append(ch)              # lone \n/\t: \s+ matches it alone
            i += 1
    return out


class BPETokenizer:
    def __init__(self, vocab_file: str, merges_file: str,
                 unk_token: str = "<|endoftext|>"):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#version") and len(l.split()) == 2]
        self.bpe_ranks: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.unk = unk_token
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 60))
            if best not in self.bpe_ranks:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in pretokenize(text):
            mapped = "".join(self.byte_encoder[b]
                             for b in tok.encode("utf-8"))
            out.extend(self._bpe(mapped))
        return out

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        unk = self.encoder.get(self.unk, 0)
        return [self.encoder.get(t, unk) for t in tokens]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def decode(self, ids) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytes(self.byte_decoder[c] for c in text
                     if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")

    def __call__(self, text, **_):
        if isinstance(text, str):
            return {"input_ids": self.encode(text)}
        return {"input_ids": [self.encode(t) for t in text]}

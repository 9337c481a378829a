"""Self-contained WordPiece tokenizer (BERT vocab.txt based).

Counterpart of the reference's ``harness/tokenization.py``: basic
whitespace/punctuation/CJK splitting + accent stripping, then greedy
longest-match-first WordPiece, so the harnesses run without
``transformers`` (which ``load_tokenizer`` still prefers where it can be
imported; this is the fallback, and the one that runs on the card's
machine).

The callable API mirrors the HF fast-tokenizer call used by
the reference's harness/data.py:encode_glue_batch:

    tok = WordPieceTokenizer("vocab.txt")
    enc = tok(texts_a, texts_b, padding="max_length", truncation=True,
              max_length=128)
    enc["input_ids"], enc["token_type_ids"], enc["attention_mask"]

Pair truncation follows the reference's ``_truncate_seq_pair`` (pop from
the longer sequence until total fits), which biases toward equal lengths
rather than HF's 'longest_first' tie-breaking; identical for single texts.
"""

from __future__ import annotations

import collections
import os
import unicodedata
from typing import Dict, List, Optional, Sequence

__all__ = ["WordPieceTokenizer", "load_vocab", "load_tokenizer",
           "basic_tokenize", "wordpiece_tokenize"]


def load_vocab(path: str) -> Dict[str, int]:
    vocab = collections.OrderedDict()
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges count as punctuation (reference
    # tokenization.py semantics, matching HF BasicTokenizer)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_tokenize(text: str, lower: bool = True,
                   never_split: Sequence[str] = ()) -> List[str]:
    """Clean + whitespace/CJK/punctuation split (+ lowercase, strip
    accents)."""
    out_chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out_chars.append(" ")
        elif _is_cjk(cp):
            out_chars.append(f" {ch} ")
        else:
            out_chars.append(ch)
    tokens = "".join(out_chars).split()

    split_tokens: List[str] = []
    for tok in tokens:
        if tok in never_split:
            split_tokens.append(tok)
            continue
        if lower:
            tok = tok.lower()
            tok = unicodedata.normalize("NFD", tok)
            tok = "".join(c for c in tok
                          if unicodedata.category(c) != "Mn")
        cur: List[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    split_tokens.append("".join(cur))
                    cur = []
                split_tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            split_tokens.append("".join(cur))
    return split_tokens


def wordpiece_tokenize(token: str, vocab: Dict[str, int],
                       unk: str = "[UNK]",
                       max_chars: int = 200) -> List[str]:
    """Greedy longest-match-first WordPiece of one basic token."""
    return [p for p, _ in wordpiece_with_spans(token, vocab, unk,
                                               max_chars)]


def wordpiece_with_spans(token: str, vocab: Dict[str, int],
                         unk: str = "[UNK]", max_chars: int = 200):
    """-> [(piece, (start, end))] with char spans into ``token``."""
    if len(token) > max_chars:
        return [(unk, (0, len(token)))]
    pieces = []
    start = 0
    while start < len(token):
        end = len(token)
        cur = None
        while start < end:
            sub = token[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                cur = sub
                break
            end -= 1
        if cur is None:
            return [(unk, (0, len(token)))]
        pieces.append((cur, (start, end)))
        start = end
    return pieces


def _normalize_word(word: str, lower: bool):
    """Per-char lowercase + accent strip with an index map back into the
    original word (normalized char i came from word[idx[i]])."""
    chars: List[str] = []
    idx: List[int] = []
    for i, ch in enumerate(word):
        c = ch.lower() if lower else ch
        if lower:
            c = unicodedata.normalize("NFD", c)
            c = "".join(x for x in c if unicodedata.category(x) != "Mn")
        for x in c:
            chars.append(x)
            idx.append(i)
    return "".join(chars), idx


def tokenize_with_offsets(text: str, vocab: Dict[str, int],
                          lower: bool = True, unk: str = "[UNK]"):
    """-> (tokens, [(start, end)]) with char offsets into ``text``.

    Same pipeline as tokenize() (basic split + WordPiece), tracking source
    spans through cleaning, lowercasing, accent stripping and CJK/
    punctuation splitting — what SQuAD answer extraction needs."""
    tokens: List[str] = []
    offsets: List[tuple] = []
    # maximal non-space runs with their start position
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if _is_whitespace(ch) or _is_control(ch) or ord(ch) in (0, 0xFFFD):
            i += 1
            continue
        j = i
        while j < n and not (_is_whitespace(text[j]) or _is_control(text[j])
                             or ord(text[j]) in (0, 0xFFFD)):
            j += 1
        word = text[i:j]
        norm, idx = _normalize_word(word, lower)
        # split norm into punctuation / CJK / plain segments
        segs = []      # (norm_start, norm_end)
        s = 0
        for k, c in enumerate(norm):
            if _is_punctuation(c) or _is_cjk(ord(c)):
                if s < k:
                    segs.append((s, k))
                segs.append((k, k + 1))
                s = k + 1
        if s < len(norm):
            segs.append((s, len(norm)))
        for (a, b) in segs:
            seg = norm[a:b]
            for piece, (ps, pe) in wordpiece_with_spans(seg, vocab, unk):
                o_start = idx[a + ps]
                o_end = idx[a + pe - 1] + 1
                tokens.append(piece)
                offsets.append((i + o_start, i + o_end))
        i = j
    return tokens, offsets


class QAEncoding(dict):
    """Minimal HF-BatchEncoding-compatible result for the QA flow."""

    def __init__(self, data: dict, seq_ids: List[List[Optional[int]]]):
        super().__init__(data)
        self._seq_ids = seq_ids

    def sequence_ids(self, i: int) -> List[Optional[int]]:
        return self._seq_ids[i]


class WordPieceTokenizer:
    """BERT-style tokenizer over a vocab.txt, HF-call-compatible."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]", unk_token: str = "[UNK]"):
        self.vocab = load_vocab(vocab_file)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.cls_token, self.sep_token = cls_token, sep_token
        self.pad_token, self.unk_token = pad_token, unk_token
        self.special = (cls_token, sep_token, pad_token, unk_token,
                        "[MASK]")

    # -- core ---------------------------------------------------------------
    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in basic_tokenize(text, self.do_lower_case, self.special):
            if tok in self.special:
                out.append(tok)
            else:
                out.extend(wordpiece_tokenize(tok, self.vocab,
                                              self.unk_token))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.inv_vocab.get(int(i), self.unk_token) for i in ids]

    # -- HF-style batch call --------------------------------------------------
    def __call__(self, texts, texts_b=None, padding: str = "max_length",
                 truncation=True, max_length: int = 128,
                 stride: int = 0, return_overflowing_tokens: bool = False,
                 return_offsets_mapping: bool = False):
        if truncation == "only_second" or return_offsets_mapping:
            assert isinstance(texts, str) and isinstance(texts_b, str), \
                "QA encoding path takes one (question, context) pair"
            return self._encode_qa(texts, texts_b, max_length, stride)
        if isinstance(texts, str):
            texts = [texts]
        if isinstance(texts_b, str):
            texts_b = [texts_b]
        ids, type_ids, mask = [], [], []
        for i, a in enumerate(texts):
            b = texts_b[i] if texts_b is not None else None
            row = self._encode_pair(a, b, truncation, max_length)
            ids.append(row[0])
            type_ids.append(row[1])
            mask.append(row[2])
        if padding == "max_length":
            pad_id = self.vocab[self.pad_token]
            for row, tt, mm in zip(ids, type_ids, mask):
                fill = max_length - len(row)
                row += [pad_id] * fill
                tt += [0] * fill
                mm += [0] * fill
        return {"input_ids": ids, "token_type_ids": type_ids,
                "attention_mask": mask}

    def _encode_pair(self, a: str, b: Optional[str], truncation: bool,
                     max_length: int):
        ta = self.tokenize(a)
        tb = self.tokenize(b) if b is not None else None
        if truncation:
            if tb is not None:
                # reference BERT/run_glue.py _truncate_seq_pair: pop from
                # the longer until the pair fits (3 specials)
                while len(ta) + len(tb) > max_length - 3:
                    (ta if len(ta) > len(tb) else tb).pop()
            else:
                ta = ta[:max_length - 2]
        toks = [self.cls_token] + ta + [self.sep_token]
        types = [0] * len(toks)
        if tb is not None:
            toks += tb + [self.sep_token]
            types += [1] * (len(tb) + 1)
        ids = self.convert_tokens_to_ids(toks)
        return ids, types, [1] * len(ids)

    def _encode_qa(self, question: str, context: str, max_length: int,
                   stride: int) -> "QAEncoding":
        """Sliding-window (question, context) features with offset
        mappings, HF fast-tokenizer QA semantics: windows overlap by
        ``stride`` context tokens; question/specials get offset (0, 0) and
        sequence id None/0; context tokens sequence id 1."""
        q_ids = self.convert_tokens_to_ids(self.tokenize(question))
        c_toks, c_offs = tokenize_with_offsets(context, self.vocab,
                                               self.do_lower_case,
                                               self.unk_token)
        c_ids = self.convert_tokens_to_ids(c_toks)
        cls_id = self.vocab[self.cls_token]
        sep_id = self.vocab[self.sep_token]
        pad_id = self.vocab[self.pad_token]

        span = max_length - len(q_ids) - 3
        if span <= 0:
            raise ValueError("question longer than max_length")
        step = max(1, span - stride)
        starts, s = [], 0
        while True:
            starts.append(s)
            if s + span >= len(c_ids):
                break
            s += step

        ids, types, mask, offs, seq_ids = [], [], [], [], []
        for s in starts:
            w_ids = c_ids[s:s + span]
            w_off = c_offs[s:s + span]
            row = [cls_id] + q_ids + [sep_id] + w_ids + [sep_id]
            tt = [0] * (len(q_ids) + 2) + [1] * (len(w_ids) + 1)
            sq = ([None] + [0] * len(q_ids) + [None]
                  + [1] * len(w_ids) + [None])
            om = ([(0, 0)] * (len(q_ids) + 2) + list(w_off) + [(0, 0)])
            am = [1] * len(row)
            fill = max_length - len(row)
            row += [pad_id] * fill
            tt += [0] * fill
            sq += [None] * fill
            om += [(0, 0)] * fill
            am += [0] * fill
            ids.append(row)
            types.append(tt)
            mask.append(am)
            offs.append(om)
            seq_ids.append(sq)
        return QAEncoding({"input_ids": ids, "token_type_ids": types,
                           "attention_mask": mask, "offset_mapping": offs},
                          seq_ids)


def load_tokenizer(path: str, prefer_hf: bool = True):
    """Load a tokenizer from a local directory or vocab file.

    Tries the HF AutoTokenizer for full fidelity when ``transformers`` is
    importable and the dir has tokenizer configs; otherwise falls back to
    the self-contained implementations: WordPiece for a vocab.txt, GPT-2
    byte-level BPE (harness/bpe.py) for vocab.json + merges.txt.
    """
    vocab = path
    if os.path.isdir(path):
        vocab = os.path.join(path, "vocab.txt")
    if prefer_hf and os.path.isdir(path):
        try:
            from transformers import AutoTokenizer
            return AutoTokenizer.from_pretrained(path)
        except Exception:
            pass
    if os.path.exists(vocab):
        # BERT convention: lowercase unless the name says "-cased"
        # ("uncased" contains "cased", so test for uncased first)
        base = (os.path.basename(os.path.abspath(path)) + " "
                + vocab).lower()
        lower = "uncased" in base or "cased" not in base
        return WordPieceTokenizer(vocab, do_lower_case=lower)
    base = path if os.path.isdir(path) else os.path.dirname(path) or "."
    vj = os.path.join(base, "vocab.json")
    mt = os.path.join(base, "merges.txt")
    if os.path.exists(vj) and os.path.exists(mt):
        from .bpe import BPETokenizer
        return BPETokenizer(vj, mt)
    raise FileNotFoundError(f"no tokenizer at {path} (need an HF dir, a "
                            f"vocab.txt, or vocab.json + merges.txt)")

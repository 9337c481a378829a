"""PyTorch port vs the JAX reference: the self-contained tokenizers
(``harness/bpe.py``, ``harness/tokenization.py``) and the LM half of
``harness/data.py``, on synthetic vocab files built here (a byte-level
BPE vocabulary of the 256 byte symbols and merges learned from a small
corpus; a WordPiece vocab.txt). Ids, tokens, ``decode``, the HF-style
batch calls, QA windows with offsets, ``load_tokenizer``'s choice,
``lm_blocks``, ``batched`` and ``TextDataset.from_text_file`` are
identical to the reference's."""

import collections
import json

import numpy as np
import pytest

from ant_quantization_tpu.harness import bpe as jbpe
from ant_quantization_tpu.harness import data as jdata
from ant_quantization_tpu.harness import tokenization as jtok
from ant_quantization_tpu_torch.harness import bpe as tbpe
from ant_quantization_tpu_torch.harness import data as tdata
from ant_quantization_tpu_torch.harness import tokenization as ttok

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

TEXTS = [
    "Hello world, hello World!",
    "don't can't we'll I'm you're they've she'd it's 'quoted' ''x''",
    "  leading and   multiple   spaces\tand\ttabs\n\nnew lines   ",
    "unicode: café naïve Ünïcödé résumé 中文字符 日本語 🙂",
    "numbers 123 and mixed abc123 def; price: $4.99 (50% off!)",
    "punctuation... ?! -- [brackets] {braces} <angle> @#%^&*",
    "",
    " ",
    "x",
]


def _train_bpe(corpus: str, n_merges: int):
    """Byte-level BPE on ``corpus``: the 256 byte symbols, then the most
    frequent adjacent pair merged, ``n_merges`` times."""
    enc = jbpe.bytes_to_unicode()
    words = collections.Counter(
        "".join(enc[b] for b in w.encode("utf-8"))
        for w in jbpe.pretokenize(corpus))
    seqs = {w: list(w) for w in words}
    vocab = {ch: i for i, ch in enumerate(enc.values())}
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, n in words.items():
            s = seqs[w]
            for a, b in zip(s, s[1:]):
                pairs[a, b] += n
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        for w in seqs:
            s, out, i = seqs[w], [], 0
            while i < len(s):
                if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            seqs[w] = out
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    vocab, merges = _train_bpe(" ".join(TEXTS) * 3, 120)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return d


@pytest.fixture(scope="module")
def wp_vocab(tmp_path_factory):
    d = tmp_path_factory.mktemp("wp")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world",
             "don", "'", "t", "can", "we", "ll", "uni", "##code", "cafe",
             "naive", "resume", "123", "abc", "##12", "##3", "def", "$",
             "4", ".", "99", "(", "50", "%", "off", "!", ",", "中", "文",
             "字", "日", "本", "the", "##s", "##ing", "lead", "##ing",
             "multiple", "space", "tab", "new", "line", "price", ":",
             "?", "-", "[", "]", "{", "}", "<", ">", "@", "#", "^", "&",
             "*", "quoted", "x", "and", "mixed", "numbers", "punctuation"]
    path = d / "vocab.txt"
    path.write_text("\n".join(dict.fromkeys(words)) + "\n")
    return str(path)


def test_bpe_pieces_equal_reference(bpe_dir):
    for text in TEXTS:
        assert tbpe.pretokenize(text) == jbpe.pretokenize(text), text
    assert tbpe.bytes_to_unicode() == jbpe.bytes_to_unicode()
    args = (str(bpe_dir / "vocab.json"), str(bpe_dir / "merges.txt"))
    t, j = tbpe.BPETokenizer(*args), jbpe.BPETokenizer(*args)
    assert len(t.bpe_ranks) == 120
    for text in TEXTS:
        ids = t.encode(text)
        assert t.tokenize(text) == j.tokenize(text), text
        assert ids == j.encode(text), text
        assert t.decode(ids) == j.decode(ids) == text, text
        assert t(text) == j(text)
    assert t(TEXTS) == j(TEXTS)
    assert any(len(p) > 1 for p in t.tokenize(TEXTS[0]))   # merges ran


def test_wordpiece_equals_reference(wp_vocab):
    t, j = ttok.WordPieceTokenizer(wp_vocab), jtok.WordPieceTokenizer(
        wp_vocab)
    for text in TEXTS:
        assert t.tokenize(text) == j.tokenize(text), text
        assert (ttok.tokenize_with_offsets(text, t.vocab)
                == jtok.tokenize_with_offsets(text, j.vocab)), text
    assert t(TEXTS, max_length=24) == j(TEXTS, max_length=24)
    assert (t(TEXTS[:3], TEXTS[3:6], max_length=20)
            == j(TEXTS[:3], TEXTS[3:6], max_length=20))
    qa_t = t("where is it?", TEXTS[3] * 3, max_length=24, stride=4,
             truncation="only_second", return_offsets_mapping=True)
    qa_j = j("where is it?", TEXTS[3] * 3, max_length=24, stride=4,
             truncation="only_second", return_offsets_mapping=True)
    assert dict(qa_t) == dict(qa_j)
    assert [qa_t.sequence_ids(i) for i in range(len(qa_t["input_ids"]))] \
        == [qa_j.sequence_ids(i) for i in range(len(qa_j["input_ids"]))]
    ids = t.convert_tokens_to_ids(t.tokenize(TEXTS[3]))
    assert t.convert_ids_to_tokens(ids) == j.convert_ids_to_tokens(ids)


def test_load_tokenizer_picks_as_the_reference(bpe_dir, wp_vocab):
    for path in (str(bpe_dir), wp_vocab):
        t = ttok.load_tokenizer(path, prefer_hf=False)
        j = jtok.load_tokenizer(path, prefer_hf=False)
        assert type(t).__name__ == type(j).__name__
        assert t(TEXTS[1])["input_ids"] == j(TEXTS[1])["input_ids"]
    with pytest.raises(FileNotFoundError):
        ttok.load_tokenizer(str(bpe_dir.parent), prefer_hf=False)


def test_lm_data_equals_reference(bpe_dir, tmp_path):
    ids = np.random.default_rng(0).integers(0, 500, 1000)
    for block in (7, 64, 1000, 1001):
        np.testing.assert_array_equal(tdata.lm_blocks(ids, block),
                                      jdata.lm_blocks(ids, block))
    blocks = jdata.lm_blocks(ids, 16)
    for drop in (False, True):
        for a, b in zip(tdata.batched(blocks, 4, drop),
                        jdata.batched(blocks, 4, drop), strict=True):
            np.testing.assert_array_equal(a, b)
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(TEXTS * 4), encoding="utf-8")
    tok = tbpe.BPETokenizer(str(bpe_dir / "vocab.json"),
                            str(bpe_dir / "merges.txt"))
    for max_chars in (None, 100):
        got = tdata.TextDataset.from_text_file(str(path), tok, 8, max_chars)
        want = jdata.TextDataset.from_text_file(str(path), tok, 8, max_chars)
        assert got.blocks.dtype == np.int32
        np.testing.assert_array_equal(got.blocks, want.blocks)


def test_from_hf_reads_only_a_local_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="never the hub"):
        tdata.TextDataset.from_hf("wikitext", "wikitext-2-raw-v1",
                                  "validation", None, 16)

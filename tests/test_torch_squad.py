"""PyTorch port vs the JAX reference: the SQuAD harness (``harness/
qa_utils.py``, ``tools/squad_run.py``) on the CPU, on generated SQuAD
v1.1 and v2.0 documents (``chip_smoke.py:squad_doc``: short contexts of
generated sentences, answers cut from them, every third v2.0 question
unanswerable) and a WordPiece vocabulary learned from the same text:

- ``load_squad_json``, ``prepare_features`` (sliding windows with the
  port's WordPiece against the reference's with its own) and
  ``squad_references`` equal to the reference's, every feature field;
- ``postprocess_predictions`` on seeded logits: the same answers, v1.1
  and v2.0 (null answers);
- ``squad_run.main`` against the reference's (in process, both base
  presets patched to a 2-layer BERT of d_model 32 with the QA head, on a
  generated HF directory): v1.1 under the CLI's defaults (OliVe
  "ant-int-flint" W4A4, calibration on the first batch) and v2.0
  unquantized; the same answers, and EM/F1 equal.
"""

import contextlib
import functools
import json
import os
import tempfile
from unittest import mock

import numpy as np
import pytest

from ant_quantization_tpu.harness import qa_utils as jQ
from ant_quantization_tpu.harness import tokenization as jtok
from ant_quantization_tpu_torch.harness import qa_utils as tQ
from ant_quantization_tpu_torch.harness import tokenization as ttok
from ant_quantization_tpu_torch.tools import squad_run

import chip_smoke as cs
from test_torch_glue import (assert_same_json, hf_dir, run_port,
                             run_reference, sentences, tiny_presets,
                             vocab_file)

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

MAX_SEQ, STRIDE = 64, 16


@functools.lru_cache(maxsize=None)
def squad_file(version_2: bool, n: int = 6) -> str:
    d = tempfile.mkdtemp(prefix="squad_")
    path = os.path.join(d, "dev.json")
    doc = cs.squad_doc(list(sentences()), n, np.random.default_rng(
        int(version_2)), version_2, context_sentences=6)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


@functools.lru_cache(maxsize=None)
def features(version_2: bool):
    path = squad_file(version_2)
    jex, tex = jQ.load_squad_json(path), tQ.load_squad_json(path)
    jf = jQ.prepare_features(jex, jtok.load_tokenizer(vocab_file()),
                             MAX_SEQ, STRIDE)
    tf = tQ.prepare_features(tex, ttok.load_tokenizer(vocab_file()),
                             MAX_SEQ, STRIDE)
    return jex, tex, jf, tf


@pytest.mark.parametrize("version_2", [False, True])
def test_load_and_prepare_features(version_2):
    jex, tex, jf, tf = features(version_2)
    assert tex == jex
    assert tQ.squad_references(tex) == jQ.squad_references(jex)
    assert len(tf) == len(jf) > len(tex)          # several windows each
    for a, b in zip(tf, jf):
        assert set(a) == set(b)
        assert a["example_id"] == b["example_id"]
        assert a["offset_mapping"] == b["offset_mapping"]
        for k in ("input_ids", "token_type_ids", "attention_mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("version_2", [False, True])
def test_postprocess_predictions(version_2):
    jex, tex, jf, tf = features(version_2)
    rng = np.random.default_rng(9)
    s = rng.normal(size=(len(tf), MAX_SEQ)).astype(np.float32)
    e = rng.normal(size=(len(tf), MAX_SEQ)).astype(np.float32)
    # every feature of the first example prefers the null answer
    first = [i for i, f in enumerate(tf) if f["example_id"] == tex[0]["id"]]
    s[first, 0] += 20.0
    e[first, 0] += 20.0
    got = tQ.postprocess_predictions(tex, tf, s, e, version_2=version_2)
    want = jQ.postprocess_predictions(jex, jf, s, e, version_2=version_2)
    assert got == want
    assert any(got.values())
    assert (got[tex[0]["id"]] == "") == version_2


@contextlib.contextmanager
def recorded_answers():
    """Both packages' ``postprocess_predictions`` wrapped to keep the
    answers they return."""
    answers = {}

    def wrap(tag, real):
        def rec(*a, **kw):
            answers[tag] = real(*a, **kw)
            return answers[tag]
        return rec

    with mock.patch.object(jQ, "postprocess_predictions",
                           wrap("reference", jQ.postprocess_predictions)), \
            mock.patch.object(tQ, "postprocess_predictions",
                              wrap("port", tQ.postprocess_predictions)):
        yield answers


@pytest.mark.parametrize("version_2", [False, True])
def test_squad_run_main_against_the_reference(version_2):
    argv = ["--data", squad_file(version_2), "--weights",
            hf_dir("bert", "qa"), "--tokenizer", vocab_file(),
            "--max_seq_length", str(MAX_SEQ), "--doc_stride", str(STRIDE),
            "--batch_size", "8", "--calib_batches", "1"]
    if version_2:
        argv += ["--version_2", "--disable_quant"]
    with tiny_presets(), recorded_answers() as answers:
        want = run_reference("squad_run", argv)
        got = run_port(squad_run.main, argv)
    assert answers["port"] == answers["reference"]
    assert len(answers["port"]) == 6
    assert_same_json(got, want)

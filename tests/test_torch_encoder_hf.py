"""PyTorch port vs the JAX reference: HF checkpoint import of the encoders
(``models/bert.py:import_hf_bert``, ``models/bart.py:import_hf_bart``),
on ``transformers`` models built from local config classes (2-layer
BERT, 1 + 1-layer BART, d_model 32, 4 heads, d_ff 64, vocab 128): the
classification head, the QA head and the bare model. The port's tree
equals the reference's leaf for leaf (the port fed torch tensors, the
reference numpy), and the port's model on it gives HF's logits within
rtol/atol 2e-4, as ``tests/test_hf_parity.py`` holds the reference's
(BERT on padded rows with two token types; BART on eos-terminated rows,
which HF needs to pool). These cases share one file because importing
``transformers`` is most of their time.
"""

import numpy as np
import pytest
import torch

from ant_quantization_tpu.models import bart as jba
from ant_quantization_tpu.models import bert as jb
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.models import bart as tba
from ant_quantization_tpu_torch.models import bert as tb
from ant_quantization_tpu_torch.nn.config import QuantConfig as TQ

import test_torch_bart as tbart
import test_torch_bert as tbert

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

transformers = pytest.importorskip("transformers")

pytestmark = pytest.mark.torchdep

HF_TOL = dict(rtol=2e-4, atol=2e-4)
KINDS = ("classification", "qa", "bare")


def hf_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def assert_same_tree(got, want, path=()):
    assert set(got) == set(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            assert_same_tree(got[k], w, path + (k,))
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                          err_msg=str(path + (k,)))


def hold_logits(hf, tm, kind, args, kwargs):
    """The port's model against HF's on the same inputs."""
    with torch.no_grad():
        ref = hf(*args, **kwargs)
        out = tm(*args, *kwargs.values())
    if kind == "qa":
        pairs = ((out[0], ref.start_logits), (out[1], ref.end_logits))
    else:
        pairs = ((out, ref.logits),)
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), w.numpy(), **HF_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_import_hf_bert(kind):
    hf_cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
        num_labels=2 if kind == "qa" else 3)
    torch.manual_seed(0)
    cls = {"classification": transformers.BertForSequenceClassification,
           "qa": transformers.BertForQuestionAnswering,
           "bare": transformers.BertModel}[kind]
    hf = cls(hf_cfg).eval()
    sd = hf_state(hf)
    head = "qa" if kind == "qa" else "classification"
    geom = dict(tbert.GEOM, d_ff=64)
    want = jb.import_hf_bert(sd, jb.BertConfig(**geom), head=head)
    got = tb.import_hf_bert({k: torch.from_numpy(v) for k, v in sd.items()},
                            tb.BertConfig(**geom), head=head)
    assert_same_tree(got, want)
    if kind == "bare":
        assert set(got) == {"bert", "pooler"}
        return
    tm = tbert.HEADS["qa" if kind == "qa" else "cls"][1](
        tb.BertConfig(**geom), TQ(enabled=False), device="cpu")
    tm.load_state_dict(convert.from_jax_lm_params(want, device="cpu"))
    ids, tt, am = (torch.from_numpy(a) for a in tbert.batch(2))
    hold_logits(hf, tm, kind, (ids,),
                dict(token_type_ids=tt, attention_mask=am))


@pytest.mark.parametrize("kind", KINDS)
def test_import_hf_bart(kind):
    hf_cfg = transformers.BartConfig(
        vocab_size=128, d_model=32, encoder_layers=1, decoder_layers=1,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_position_embeddings=64, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, classifier_dropout=0.0,
        eos_token_id=tbart.EOS, pad_token_id=1,
        num_labels=2 if kind == "qa" else 3)
    torch.manual_seed(0)
    cls = {"classification": transformers.BartForSequenceClassification,
           "qa": transformers.BartForQuestionAnswering,
           "bare": transformers.BartModel}[kind]
    hf = cls(hf_cfg).eval()
    sd = hf_state(hf)
    head = "qa" if kind == "qa" else "classification"
    geom = dict(tbart.GEOM, d_ff=64)
    want = jba.import_hf_bart(sd, jba.BartConfig(**geom), head=head)
    got = tba.import_hf_bart({k: torch.from_numpy(v) for k, v in sd.items()},
                             tba.BartConfig(**geom), head=head)
    assert_same_tree(got, want)
    if kind == "bare":
        assert set(got) == {"model"}
        return
    tm = tbart.HEADS["qa" if kind == "qa" else "cls"][1](
        tba.BartConfig(**geom), TQ(enabled=False), device="cpu")
    tm.load_state_dict(convert.from_jax_lm_params(want, device="cpu"))
    ids = np.random.default_rng(5).integers(3, 128, (2, 12))
    ids[:, -1] = tbart.EOS
    hold_logits(hf, tm, kind, (torch.from_numpy(ids),), {})

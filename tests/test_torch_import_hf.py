"""PyTorch port vs the JAX reference: HF checkpoint import
(``models/import_hf.py``, the LM half of ``harness/zoo.py``) and the
port's own safetensors reader and writer (``harness/safetensors_io.py``).

- ``lm_config_from_hf`` equal to the reference's field by field;
- tiny ``transformers`` GPT-2, OPT and BLOOM models saved as sharded
  safetensors and as ``pytorch_model.bin``: the port's ``get_lm`` gives
  the reference's params tree bit for bit (the reference's own
  ``load_hf_model_dir`` and importer on the same directory), and its
  ``TransformerLM`` on the CPU gives HF's logits within rtol/atol 2e-4,
  as ``tests/test_hf_parity.py`` holds the reference's;
- the reader equal to ``safetensors.torch`` and ``safetensors.numpy``
  on F32, F16, BF16, I8 and the other types, and the library reading
  the port's files back.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")
safetensors_numpy = pytest.importorskip("safetensors.numpy")

from safetensors import safe_open

from ant_quantization_tpu.harness import zoo as jzoo
from ant_quantization_tpu.models import import_hf as jimp
from ant_quantization_tpu_torch.harness import safetensors_io as st
from ant_quantization_tpu_torch.harness import zoo as tzoo
from ant_quantization_tpu_torch.models import import_hf as timp
from ant_quantization_tpu_torch.nn.config import QuantConfig

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

TOL = dict(rtol=2e-4, atol=2e-4)


def _hf_model(family):
    torch.manual_seed(0)
    if family == "gpt2":
        cfg = transformers.GPT2Config(
            vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4,
            attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0)
        return transformers.GPT2LMHeadModel(cfg).eval()
    if family == "opt":
        cfg = transformers.OPTConfig(
            vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, ffn_dim=128, max_position_embeddings=64,
            dropout=0.0, do_layer_norm_before=True, word_embed_proj_dim=32)
        return transformers.OPTForCausalLM(cfg).eval()
    cfg = transformers.BloomConfig(
        vocab_size=128, hidden_size=32, n_layer=2, n_head=4,
        hidden_dropout=0.0, attention_dropout=0.0)
    return transformers.BloomForCausalLM(cfg).eval()


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _cfg_fields(cfg):
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(d["dtype"]).replace("torch.", "")
    return d


@pytest.mark.parametrize("family", ["gpt2", "opt", "bloom"])
def test_lm_config_from_hf_equals_reference(family):
    config = _hf_model(family).config.to_dict()
    jfam, jcfg = jzoo.lm_config_from_hf(config)
    tfam, tcfg = tzoo.lm_config_from_hf(config)
    assert tfam == jfam == family
    want = dataclasses.asdict(jcfg)
    want["dtype"] = np.dtype(want["dtype"]).name
    assert _cfg_fields(tcfg) == want
    with pytest.raises(ValueError, match="unsupported"):
        tzoo.lm_config_from_hf({"model_type": "llama"})


@pytest.mark.parametrize("fmt", ["sharded", "bin"])
@pytest.mark.parametrize("family", ["gpt2", "opt", "bloom"])
def test_get_lm_imports_the_reference_tree(family, fmt, tmp_path):
    hf = _hf_model(family)
    d = str(tmp_path / family)
    if fmt == "sharded":
        hf.save_pretrained(d, max_shard_size="40KB")
        shards = [f for f in sorted(os.listdir(d))
                  if f.endswith(".safetensors")]
        assert len(shards) > 1, shards
    else:
        hf.save_pretrained(d, safe_serialization=False)
    config, sd = jzoo.load_hf_model_dir(d)
    _, jcfg = jzoo.lm_config_from_hf(config)
    want = jimp.IMPORTERS[family](sd, jcfg)
    tconfig, tsd = tzoo.load_hf_model_dir(d)
    assert tconfig == config and set(tsd) == set(sd)
    for k, v in sd.items():
        assert tsd[k].dtype == torch.float32
        np.testing.assert_array_equal(tsd[k].numpy(), v, err_msg=k)
    model, cfg, got = tzoo.get_lm(d, QuantConfig(enabled=False),
                                  device="cpu")
    assert _cfg_fields(cfg)["d_model"] == jcfg.d_model
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert set(got_l) == set(want_l)
    for path, w in want_l.items():
        np.testing.assert_array_equal(np.asarray(got_l[path]), w,
                                      err_msg=str(path))
    # the importer on the reference's numpy state dict gives numpy leaves
    for path, w in _leaves(timp.IMPORTERS[family](
            jimp.torch_state_dict_to_numpy(hf), jcfg)):
        np.testing.assert_array_equal(w, want_l[path], err_msg=str(path))
    ids = np.random.default_rng(0).integers(3, 128, (2, 16))
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).logits.numpy()
        out = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_torch_state_dict_to_numpy_equals_reference():
    hf = _hf_model("opt")
    got, want = timp.torch_state_dict_to_numpy(hf), \
        jimp.torch_state_dict_to_numpy(hf)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v)


def test_get_lm_needs_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.get_lm("opt:125m", QuantConfig())


def _typed_tensors():
    g = torch.Generator().manual_seed(0)
    f = torch.randn((3, 5), generator=g)
    return {"f32": f, "f16": (f * 3).to(torch.float16),
            "bf16": (f * 7).to(torch.bfloat16),
            "i8": torch.randint(-128, 128, (7,), dtype=torch.int8,
                                generator=g),
            "u8": torch.randint(0, 256, (2, 3), dtype=torch.uint8,
                                generator=g),
            "i32": torch.arange(-6, 6, dtype=torch.int32).reshape(3, 4),
            "i64": torch.tensor([1 << 40, -3]),
            "f64": torch.tensor([0.1, -2.5], dtype=torch.float64),
            "b": torch.tensor([True, False, True]),
            "scalar": torch.tensor(2.5), "empty": torch.zeros((0, 4))}


def test_reader_equals_the_library(tmp_path):
    tensors = _typed_tensors()
    path = str(tmp_path / "lib.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"k": "v"})
    got, meta = st.read_safetensors(path)
    assert meta == {"k": "v"}
    want = safetensors_torch.load_file(path)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k
    for k, w in safetensors_numpy.load_file(path).items():
        if k != "bf16":
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_writer_is_read_by_the_library(tmp_path):
    tensors = _typed_tensors()
    path = str(tmp_path / "port.safetensors")
    st.write_safetensors(path, tensors, {"tree": json.dumps({"a": 1})})
    back = safetensors_torch.load_file(path)
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"tree": json.dumps({"a": 1})}
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    got, _ = st.read_safetensors(path)
    for k, t in tensors.items():
        assert torch.equal(got[k], t), k
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    assert n % 8 == 0


def test_reader_refuses_a_hole(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    st.write_safetensors(path, {"a": torch.ones(4)})
    with open(path, "ab") as f:
        f.write(b"\0" * 8)
    with pytest.raises(ValueError, match="header covers"):
        st.read_safetensors(path)

"""Model factory + on-disk checkpoint loading: the decoder LMs, the
BERT/BART encoders and the image classifiers.

Counterpart of the reference's ``harness/zoo.py``: model construction is
config-driven and weights come from local files:
- HF-format model directories: config.json + model*.safetensors
  (possibly sharded) or pytorch_model*.bin;
- bare torch state-dict files (.pth/.pt/.bin, read with
  ``weights_only=True``);
- .npz archives (name -> array).

Safetensors files are read by the port's own reader
(``harness/safetensors_io.py``); every value is cast to f32, as the
reference does. No network access is required or attempted. The
encoders build the base or large preset whatever the checkpoint's
config.json says, as the reference's ``get_bert``/``get_bart`` do. The
image classifiers take a torchvision state-dict file (.pth, .npz or
.safetensors), converted by the model's importer.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._ext import resolve_device
from ..models import bart as bart_mod
from ..models import bert as bert_mod
from ..models import cnn as cnn_mod
from ..models import import_hf
from ..models import inception as inc_mod
from ..models import resnet as resnet_mod
from ..models import vit as vit_mod
from ..models.transformer_lm import (LMConfig, TransformerLM, bloom_config,
                                     gpt2_config, opt_config)
from ..nn.config import QuantConfig
from .safetensors_io import read_safetensors

__all__ = ["load_state_dict_file", "load_hf_model_dir", "lm_config_from_hf",
           "get_lm", "IMAGE_MODELS", "get_image_model", "get_bert",
           "get_bart", "get_encoder_model"]


# ---------------------------------------------------------------------------
# Raw weight-file loading
# ---------------------------------------------------------------------------

def _f32(sd) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
            for k, v in sd.items()}


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Load one weight file (.safetensors, .npz, or torch .pth/.pt/.bin)
    as name -> f32 CPU tensor."""
    if path.endswith(".safetensors"):
        return _f32(read_safetensors(path)[0])
    if path.endswith(".npz"):
        with np.load(path) as z:
            return _f32({k: np.asarray(z[k], np.float32) for k in z.files})
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "model" in sd and all(
            isinstance(v, torch.Tensor) for v in sd["model"].values()):
        sd = sd["model"]
    return _f32(sd)


def load_hf_model_dir(path: str) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """HF model directory -> (config dict, merged state_dict)."""
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    sd: Dict[str, torch.Tensor] = {}
    files = sorted(os.listdir(path))
    st = [f for f in files if f.endswith(".safetensors")]
    bins = [f for f in files if f.endswith(".bin") and "pytorch_model" in f]
    for f in st or bins:
        sd.update(load_state_dict_file(os.path.join(path, f)))
    if not sd:
        raise FileNotFoundError(f"no weight files in {path}")
    return config, sd


# ---------------------------------------------------------------------------
# Decoder LMs (GPT-2 / OPT / BLOOM)
# ---------------------------------------------------------------------------

def lm_config_from_hf(config: dict) -> Tuple[str, LMConfig]:
    """Map an HF config.json to (family, LMConfig)."""
    mt = config.get("model_type", "")
    if mt == "gpt2":
        d = config["n_embd"]
        cfg = LMConfig(vocab_size=config["vocab_size"], d_model=d,
                       n_layers=config["n_layer"], n_heads=config["n_head"],
                       d_ff=config.get("n_inner") or 4 * d,
                       max_seq=config["n_positions"], positions="learned",
                       activation="gelu_new", fused_qkv=True)
        return "gpt2", cfg
    if mt == "opt":
        cfg = LMConfig(vocab_size=config["vocab_size"],
                       d_model=config["hidden_size"],
                       n_layers=config["num_hidden_layers"],
                       n_heads=config["num_attention_heads"],
                       d_ff=config["ffn_dim"],
                       max_seq=config["max_position_embeddings"],
                       positions="learned_offset2", activation="relu",
                       fused_qkv=False)
        return "opt", cfg
    if mt == "bloom":
        d = config.get("hidden_size") or config["n_embed"]
        cfg = LMConfig(vocab_size=config["vocab_size"], d_model=d,
                       n_layers=config.get("num_hidden_layers",
                                           config.get("n_layer")),
                       n_heads=config.get("num_attention_heads",
                                          config.get("n_head")),
                       d_ff=4 * d, max_seq=2048, positions="alibi",
                       activation="gelu", fused_qkv=True, embed_ln=True)
        return "bloom", cfg
    raise ValueError(f"unsupported model_type {mt!r}")


_LM_PRESETS = {
    "gpt2": lambda s: ("gpt2", gpt2_config(s or "small")),
    "opt": lambda s: ("opt", opt_config(s or "125m")),
    "bloom": lambda s: ("bloom", bloom_config(s or "560m")),
}


def get_lm(name_or_path: str, qcfg: QuantConfig, params: bool = True,
           device=None):
    """Build (model, cfg, params|None) for a decoder LM: the port's
    ``TransformerLM`` on ``device`` (default "cuda").

    ``name_or_path``: a local HF model dir, whose imported weights (the
    reference's params tree, f32 CPU tensors) are loaded into the model
    and returned; or a preset "family[:size]" (e.g. "opt:6.7b") for
    randomly initialized runs and smoke tests (params None)."""
    dev = resolve_device(device)
    if os.path.isdir(name_or_path):
        config, sd = load_hf_model_dir(name_or_path)
        family, cfg = lm_config_from_hf(config)
        model = TransformerLM(cfg, qcfg, device=dev)
        p = None
        if params:
            p = import_hf.IMPORTERS[family](sd, cfg)
            del sd
            with torch.no_grad():
                model.load_state_dict(import_hf.lm_state_dict(p))
        return model, cfg, p
    family, _, size = name_or_path.partition(":")
    family, cfg = _LM_PRESETS[family](size or None)
    return TransformerLM(cfg, qcfg, device=dev), cfg, None


# ---------------------------------------------------------------------------
# Image classifiers
# ---------------------------------------------------------------------------

IMAGE_MODELS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
                "vgg16", "vgg16_bn", "alexnet", "vit_b_16", "vit_l_16",
                "inception_v3")


def get_image_model(name: str, qcfg: QuantConfig,
                    weights_path: Optional[str] = None, device=None):
    """(model, import_fn, variables|None) for an image classifier on
    ``device`` (default "cuda"). ``weights_path``: a torchvision state
    dict file, converted by the model's importer (``import_fn``) and
    loaded into the model; ``variables`` is then ``{"params"[,
    "batch_stats"]}`` in the port's layout. Without it the model keeps
    the port's random init."""
    dev = resolve_device(device)
    name = name.lower()
    if name.startswith("resnet") and name in IMAGE_MODELS:
        cfg = getattr(resnet_mod, f"{name}_config")()
        model = resnet_mod.ResNet(cfg, qcfg, device=dev)
        conv = lambda sd: resnet_mod.import_torchvision_resnet(sd, cfg)
    elif name in ("vgg16", "vgg16_bn"):
        bn = name.endswith("_bn")
        model = cnn_mod.VGG16(qcfg, with_bn=bn, device=dev)
        if bn:
            conv = lambda sd: cnn_mod.import_torchvision_vgg16(sd, True)
        else:
            conv = lambda sd: (cnn_mod.import_torchvision_vgg16(sd), None)
    elif name == "alexnet":
        model = cnn_mod.AlexNet(qcfg, device=dev)
        conv = lambda sd: (cnn_mod.import_torchvision_alexnet(sd), None)
    elif name in ("vit_b_16", "vit_l_16"):
        cfg = getattr(vit_mod, f"{name}_config")()
        model = vit_mod.ViT(cfg, qcfg, device=dev)
        conv = lambda sd: (vit_mod.import_torchvision_vit(sd, cfg), None)
    elif name == "inception_v3":
        cfg = inc_mod.inception_v3_config()
        model = inc_mod.InceptionV3(cfg, qcfg, device=dev)
        conv = lambda sd: inc_mod.import_torchvision_inception(sd, cfg)
    else:
        raise ValueError(f"unknown image model {name!r}; "
                         f"choices: {IMAGE_MODELS}")
    if weights_path is None:
        return model, conv, None
    params, batch_stats = conv(load_state_dict_file(weights_path))
    variables = {"params": params}
    state = import_hf.lm_state_dict(params)
    if batch_stats is not None:
        variables["batch_stats"] = batch_stats
        state.update(import_hf.lm_state_dict(batch_stats))
    with torch.no_grad():
        model.load_state_dict(state)
    return model, conv, variables


# ---------------------------------------------------------------------------
# BERT / BART encoders (GLUE + SQuAD)
# ---------------------------------------------------------------------------

def _load_sd(weights_path: str) -> Dict[str, torch.Tensor]:
    if os.path.isdir(weights_path):
        return load_hf_model_dir(weights_path)[1]
    return load_state_dict_file(weights_path)


def _load_params(model, params: dict) -> None:
    """Load an imported params tree into ``model``. Entries the model has
    no place for (a pooler under the QA head) are ignored, as flax
    ignores unused params; a missing one raises."""
    with torch.no_grad():
        missing, _ = model.load_state_dict(import_hf.lm_state_dict(params),
                                           strict=False)
    if missing:
        raise KeyError(f"the checkpoint lacks {missing}")


def _encoder(cfg, cls, importer, qcfg, head, weights_path, device):
    model = cls(cfg, qcfg, device=resolve_device(device))
    params = None
    if weights_path:
        params = importer(_load_sd(weights_path), cfg, head=head)
        _load_params(model, params)
    return model, cfg, params


def get_bert(size: str, qcfg: QuantConfig, head: str = "classification",
             num_labels: int = 2, weights_path: Optional[str] = None,
             device=None):
    """(model, cfg, params|None): BERT-base or -large (``size``) with the
    GLUE (``head="classification"``) or SQuAD (``"qa"``) head on
    ``device`` (default "cuda"); the imported weights of
    ``weights_path`` (an HF dir or a weight file) loaded into it and
    returned as the reference's params tree, else a random init."""
    cfg_fn = (bert_mod.bert_large_config if size == "large"
              else bert_mod.bert_base_config)
    cls = (bert_mod.BertForQuestionAnswering if head == "qa"
           else bert_mod.BertForSequenceClassification)
    return _encoder(cfg_fn(num_labels=num_labels), cls,
                    bert_mod.import_hf_bert, qcfg, head, weights_path,
                    device)


def get_bart(size: str, qcfg: QuantConfig, head: str = "classification",
             num_labels: int = 2, weights_path: Optional[str] = None,
             device=None):
    """As :func:`get_bert`, for BART-base or -large."""
    cfg_fn = (bart_mod.bart_large_config if size == "large"
              else bart_mod.bart_base_config)
    cls = (bart_mod.BartForQuestionAnswering if head == "qa"
           else bart_mod.BartForSequenceClassification)
    return _encoder(cfg_fn(num_labels=num_labels), cls,
                    bart_mod.import_hf_bart, qcfg, head, weights_path,
                    device)


def get_encoder_model(family: str, size: str, qcfg: QuantConfig,
                      head: str = "classification", num_labels: int = 2,
                      weights_path: Optional[str] = None, device=None):
    fn = {"bert": get_bert, "bart": get_bart}[family]
    return fn(size, qcfg, head=head, num_labels=num_labels,
              weights_path=weights_path, device=device)

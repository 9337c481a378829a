"""HuggingFace-torch checkpoint import: state_dict -> the reference's
params tree.

Counterpart of the reference's ``models/import_hf.py``. Works from any
mapping of parameter name -> array (numpy arrays or torch tensors; the
tree's leaves are of the same kind), so it handles live torch modules
(tests) and sharded safetensors files on disk (``harness/zoo.py``)
without the HF modeling code.

Layout conventions of the reference's tree, which the port's
``TransformerLM`` loads through its dotted ``state_dict`` keys:
- Dense kernels are (in, out): torch nn.Linear weights (out, in)
  transpose; GPT-2 Conv1D weights are already (in, out) and copy through.
- Fused qkv kernels are (E, 3E) with contiguous [q | k | v] blocks;
  BLOOM's per-head-interleaved (H, 3, hd) rows are permuted here, so
  model code stays uniform.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .transformer_lm import LMConfig

__all__ = ["torch_state_dict_to_numpy", "import_gpt2", "import_opt",
           "import_bloom", "IMPORTERS", "lm_state_dict"]


def torch_state_dict_to_numpy(model_or_sd) -> Dict[str, np.ndarray]:
    """Accept a torch nn.Module or a state_dict; return name->np.float32."""
    sd = (model_or_sd.state_dict() if hasattr(model_or_sd, "state_dict")
          else model_or_sd)
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().float().numpy()
        out[k] = np.asarray(v, dtype=np.float32)
    return out


def _ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _linear(sd, prefix):
    """torch nn.Linear (out,in) -> (in,out)."""
    p = {"kernel": sd[f"{prefix}.weight"].T}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _conv1d(sd, prefix):
    """GPT-2 Conv1D stores (in,out) already (pytorch_utils.Conv1D)."""
    return {"kernel": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def import_gpt2(sd: Mapping, cfg: LMConfig) -> dict:
    """GPT2LMHeadModel state_dict -> TransformerLM params."""
    p = {
        "wte": {"embedding": sd["transformer.wte.weight"]},
        "wpe": {"embedding": sd["transformer.wpe.weight"]},
        "ln_f": _ln(sd, "transformer.ln_f"),
    }
    for i in range(cfg.n_layers):
        b = f"transformer.h.{i}"
        p[f"h_{i}"] = {
            "ln_1": _ln(sd, f"{b}.ln_1"),
            "ln_2": _ln(sd, f"{b}.ln_2"),
            "attn": {
                "qkv": _conv1d(sd, f"{b}.attn.c_attn"),
                "out": _conv1d(sd, f"{b}.attn.c_proj"),
            },
            "fc_in": _conv1d(sd, f"{b}.mlp.c_fc"),
            "fc_out": _conv1d(sd, f"{b}.mlp.c_proj"),
        }
    return p


def import_opt(sd: Mapping, cfg: LMConfig) -> dict:
    """OPTForCausalLM state_dict -> TransformerLM params."""
    d = "model.decoder"
    p = {
        "wte": {"embedding": sd[f"{d}.embed_tokens.weight"]},
        "wpe": {"embedding": sd[f"{d}.embed_positions.weight"]},
        "ln_f": _ln(sd, f"{d}.final_layer_norm"),
    }
    for i in range(cfg.n_layers):
        b = f"{d}.layers.{i}"
        p[f"h_{i}"] = {
            "ln_1": _ln(sd, f"{b}.self_attn_layer_norm"),
            "ln_2": _ln(sd, f"{b}.final_layer_norm"),
            "attn": {
                "q": _linear(sd, f"{b}.self_attn.q_proj"),
                "k": _linear(sd, f"{b}.self_attn.k_proj"),
                "v": _linear(sd, f"{b}.self_attn.v_proj"),
                "out": _linear(sd, f"{b}.self_attn.out_proj"),
            },
            "fc_in": _linear(sd, f"{b}.fc1"),
            "fc_out": _linear(sd, f"{b}.fc2"),
        }
    return p


def _bloom_qkv(w, b, cfg: LMConfig):
    """BLOOM fused qkv (3E, E) with per-head [q,k,v] interleave -> (E, 3E)
    with contiguous [q|k|v] blocks."""
    h, hd, e = cfg.n_heads, cfg.head_dim, cfg.d_model
    w4 = w.reshape(h, 3, hd, e)
    b3 = b.reshape(h, 3, hd)
    ks = [w4[:, j].reshape(h * hd, e).T for j in range(3)]  # (E_in, E_out)
    bs = [b3[:, j].reshape(h * hd) for j in range(3)]
    if isinstance(w, torch.Tensor):
        return {"kernel": torch.cat(ks, dim=1), "bias": torch.cat(bs)}
    return {"kernel": np.concatenate(ks, axis=1), "bias": np.concatenate(bs)}


def import_bloom(sd: Mapping, cfg: LMConfig) -> dict:
    """BloomForCausalLM state_dict -> TransformerLM params."""
    t = "transformer"
    p = {
        "wte": {"embedding": sd[f"{t}.word_embeddings.weight"]},
        "embed_ln": _ln(sd, f"{t}.word_embeddings_layernorm"),
        "ln_f": _ln(sd, f"{t}.ln_f"),
    }
    for i in range(cfg.n_layers):
        b = f"{t}.h.{i}"
        p[f"h_{i}"] = {
            "ln_1": _ln(sd, f"{b}.input_layernorm"),
            "ln_2": _ln(sd, f"{b}.post_attention_layernorm"),
            "attn": {
                "qkv": _bloom_qkv(
                    sd[f"{b}.self_attention.query_key_value.weight"],
                    sd[f"{b}.self_attention.query_key_value.bias"], cfg),
                "out": _linear(sd, f"{b}.self_attention.dense"),
            },
            "fc_in": _linear(sd, f"{b}.mlp.dense_h_to_4h"),
            "fc_out": _linear(sd, f"{b}.mlp.dense_4h_to_h"),
        }
    return p


IMPORTERS = {"gpt2": import_gpt2, "opt": import_opt, "bloom": import_bloom}


def lm_state_dict(params: Mapping, prefix: str = "") -> Dict:
    """The params tree as ``TransformerLM``'s state dict: each leaf under
    its tree path joined by dots (``h_0.attn.q.kernel``)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out.update(lm_state_dict(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out

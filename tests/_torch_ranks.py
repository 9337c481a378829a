"""What the port's parallel tests run on their ranks (not a test module).

The parallel test files start one gloo world of CPU ranks per module
(``parallel.distributed.run_ranks``); each rank imports this module,
which imports torch, numpy and the port only (never jax), runs every
case of its file and returns its local results; the parent's
parametrised tests compare them case by case with the JAX references.

The inputs are made here from seeds, so the parent and the ranks build
the same numpy arrays: the rings' operands, and the engines' float
weights with hand-built quantizer states (``engine_model``; no
calibration, whose JAX programs would take most of a file's time).
"""

from __future__ import annotations

import numpy as np
import torch

from ant_quantization_tpu_torch.numerics import codebooks as cb

WORLD = 4

# ---------------------------------------------------------------------------
# collective matmuls and the pipeline
# ---------------------------------------------------------------------------

RING_PS = (2, 4)
OVP_FORMS = ((True, False), (False, True), (True, True))


def ring_inputs(kind: str, p: int, w_ovp=False, a_ovp=False):
    """(x, w) of one ring case in the reference's layouts: all-gather x
    (p M_loc, K), w (K, p N); reduce-scatter x (M, p K_loc), w (p K_loc,
    N). f32 normal samples, codebook-range int8, or int8 sign-offset codes
    over the whole byte range for OVP operands."""
    seed = {"ag": 0, "rs": 1, "ag_i8": 3, "rs_i8": 4}[kind] + 10 * (
        2 * w_ovp + a_ovp)
    rng = np.random.default_rng(seed)
    if kind.startswith("ag"):
        xs, ws = (p * 4, 16), (16, p * 12)
    else:
        xs, ws = (8 * p, p * 8), (p * 8, 10)
    if not kind.endswith("i8"):
        return (rng.normal(size=xs).astype(np.float32),
                rng.normal(size=ws).astype(np.float32))
    x = rng.integers(-127, 128, xs) if a_ovp else rng.integers(-8, 8, xs)
    w = rng.integers(-127, 128, ws) if w_ovp else rng.integers(-8, 8, ws)
    return x.astype(np.int8), w.astype(np.int8)


def roundtrip_inputs():
    rng = np.random.default_rng(2)
    p, m, d, f = 4, 2, 16, 32
    return (rng.normal(size=(p * m, d)).astype(np.float32),
            rng.normal(size=(d, f)).astype(np.float32),
            rng.normal(size=(f, d)).astype(np.float32))


GPIPE_CASES = ((2, 4), (4, 8), (4, 3), (1, 2))


def gpipe_inputs(pp: int, M: int):
    """(stack {"w": (L, d, d), "b": (L, d)}, x (M, mb, d)) as the
    reference's pipeline tests make them."""
    L, d, mb, seed = (8, 16, 4, 1) if pp > 1 else (4, 8, 3, 2)
    rng = np.random.default_rng(0)
    stack = {"w": (rng.normal(size=(L, d, d)) / np.sqrt(d)).astype(
                 np.float32),
             "b": (rng.normal(size=(L, d)) * 0.1).astype(np.float32)}
    x = np.random.default_rng(seed).normal(size=(M, mb, d)).astype(
        np.float32)
    return stack, x


def sequential_stage(params, x):
    """tanh(h @ w + b) over the (local) layers, in order."""
    for w, b in zip(params["w"], params["b"]):
        x = torch.tanh(x @ w + b)
    return x


def collective_cases() -> dict:
    """Every ring and pipeline case: {case: this rank's output}."""
    from ant_quantization_tpu_torch.parallel import collective_matmul as cm
    from ant_quantization_tpu_torch.parallel.mesh import (axis_group,
                                                          local_shard,
                                                          make_mesh)
    from ant_quantization_tpu_torch.parallel.pipeline import (
        gpipe, shard_stage_params)
    meshes = {2: make_mesh((2, 2)), 4: make_mesh((1, 4))}
    out = {}
    t = torch.as_tensor
    for p in RING_PS:
        mesh = meshes[p]
        g = axis_group(mesh, "tp")
        sh = lambda a, spec: local_shard(t(a), mesh, spec)
        x, w = ring_inputs("ag", p)
        out[f"ag-f32-p{p}"] = cm.ring_allgather_matmul(
            sh(x, ("tp", None)), sh(w.T, ("tp", None)), g)
        x, w = ring_inputs("rs", p)
        out[f"rs-f32-p{p}"] = cm.matmul_reducescatter(
            sh(x, (None, "tp")), sh(w.T, (None, "tp")), g)
        for w_ovp, a_ovp in ((False, False),) + OVP_FORMS:
            tag = f"w{int(w_ovp)}a{int(a_ovp)}-p{p}"
            x, w = ring_inputs("ag_i8", p, w_ovp, a_ovp)
            out[f"ag-i8-{tag}"] = cm.ring_allgather_matmul_i8(
                sh(x, ("tp", None)), sh(w.T, ("tp", None)), g, w_ovp,
                a_ovp)
            x, w = ring_inputs("rs_i8", p, w_ovp, a_ovp)
            out[f"rs-i8-{tag}"] = cm.matmul_reducescatter_i8(
                sh(x, (None, "tp")), sh(w.T, (None, "tp")), g, w_ovp,
                a_ovp)
    mesh, g = meshes[4], axis_group(meshes[4], "tp")
    x, w1, w2 = roundtrip_inputs()
    h = cm.ring_allgather_matmul(local_shard(t(x), mesh, ("tp", None)),
                                 local_shard(t(w1.T), mesh, ("tp", None)), g)
    out["roundtrip-p4"] = cm.matmul_reducescatter(
        torch.tanh(h), local_shard(t(w2.T), mesh, (None, "tp")), g)
    for pp, M in GPIPE_CASES:
        mesh = (make_mesh((pp,), ("pp",)) if pp == WORLD else
                make_mesh((WORLD // pp, pp), ("dp", "pp")))
        stack, x = gpipe_inputs(pp, M)
        local = shard_stage_params({k: t(v) for k, v in stack.items()},
                                   mesh)
        out[f"gpipe-pp{pp}-M{M}"] = gpipe(sequential_stage, mesh)(local,
                                                                  t(x))
    return out


# ---------------------------------------------------------------------------
# the sharded engine
# ---------------------------------------------------------------------------

def _geom(fused=True, positions="learned", activation="gelu_new",
          max_seq=32):
    return dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                max_seq=max_seq, positions=positions, activation=activation,
                fused_qkv=fused)


_SPLIT = dict(fused=False, positions="learned_offset2", activation="relu")
_PREFILL = dict(max_seq=96)

# case: (geometry kwargs, states kind, engine kwargs, mesh (dp, tp),
# (B, T) of the prefill, what runs). The cases of the reference's
# tests/test_sharded_engine.py, on hand-built states.
ENGINE_CASES = {
    "bf16-dp1-tp2": ({}, "float", {}, (1, 2), (4, 8), "prefill"),
    "bf16-dp2-tp2": ({}, "float", {}, (2, 2), (4, 8), "prefill"),
    "bf16-dp1-tp4": ({}, "float", {}, (1, 4), (4, 8), "prefill"),
    "split-qkv-opt": (_SPLIT, "float", {}, (2, 2), (4, 8), "prefill"),
    "alibi-local-slopes": (dict(positions="alibi", activation="gelu"),
                           "float", {}, (1, 4), (4, 8), "prefill"),
    "w4a4-int8kv": ({}, "ant", dict(weight_mode="w4", act_bits=4,
                                    kv_int8=True), (2, 2), (4, 8),
                    "prefill"),
    "decode-step": ({}, "float", dict(kv_int8=True), (2, 2), (4, 8),
                    "decode"),
    "continuous-batching": ({}, "float", dict(kv_int8=True), (1, 4),
                            (2, 8), "batcher"),
    "biases-counted-once": ({}, "float-big-bias", {}, (1, 4), (4, 8),
                            "prefill"),
    "w4pack": ({}, "ant", dict(weight_mode="w4pack", act_bits=0), (1, 4),
               (4, 8), "prefill"),
    "int8-head": (_SPLIT, "float", dict(lm_head_int8=True), (2, 2), (4, 8),
                  "prefill"),
    "w4-ovp": ({}, "olive", dict(weight_mode="w4", act_bits=4,
                                 kv_int8=True), (1, 2), (4, 8), "prefill"),
    "sp-ant-fused": (_PREFILL, "ant", dict(weight_mode="w4", act_bits=4,
                                           kv_int8=True, max_seq=96),
                     (1, 4), (2, 64), "sp"),
    "sp-ant-split": (dict(_PREFILL, fused=False), "ant",
                     dict(weight_mode="w4", act_bits=4, kv_int8=True,
                          max_seq=96), (1, 4), (2, 64), "sp"),
    "sp-olive-fused": (_PREFILL, "olive", dict(weight_mode="w4", act_bits=4,
                                               kv_int8=True, max_seq=96),
                       (1, 4), (2, 64), "sp"),
    "sp-olive-split": (dict(_PREFILL, fused=False), "olive",
                       dict(weight_mode="w4", act_bits=4, kv_int8=True,
                            max_seq=96), (1, 4), (2, 64), "sp"),
    "sp-last-index": (_PREFILL, "ant", dict(weight_mode="w4", act_bits=4,
                                            kv_int8=True, max_seq=96),
                      (1, 4), (2, 64), "sp_last"),
}
ENGINE_DEFAULTS = dict(weight_mode="bf16", act_bits=0, kv_int8=False,
                       max_seq=16)
SP_LAST_INDEX = (63, 32)
BATCHER_REQUESTS = (([1, 2, 3], 4), ([4, 5], 3))


def _pad(a, size: int = 256):
    return np.pad(np.asarray(a, np.float32), (0, size - len(a)),
                  mode="edge")


def np_state(alpha, grid, outliers=None) -> dict:
    """A quantizer state's fields as numpy (a calibrated 4-bit state)."""
    return {"alpha": np.asarray(alpha, np.float32), "grid": _pad(grid),
            "outliers": (_pad(outliers) if outliers is not None
                         else np.zeros(256, np.float32)),
            "bit": np.int32(4), "mode_idx": np.int32(0),
            "is_signed": np.bool_(True), "mse": np.float32(0.0),
            "initialized": np.bool_(True), "aux": np.float32(0.0)}


def engine_model(geom: dict, kind: str, seed: int = 0):
    """Float params (the reference's tree, nonzero biases everywhere:
    std 0.05, or 1 for "float-big-bias", where a bias added once per rank
    would stand out) and, for "ant" / "olive", hand-built quantizer
    states: ANT flint W4 per output channel and flint A4; OliVe int (q, k,
    v, qkv) or flint W4 grids with their outliers at 2.5 sigma per
    channel, and signed OliVe flint A4 with outliers."""
    rng = np.random.default_rng(seed)
    bias_std = 1.0 if kind == "float-big-bias" else 0.05
    f32 = lambda a: np.asarray(a, np.float32)
    d, ff, V = geom["d_model"], geom["d_ff"], geom["vocab_size"]
    sites = ({"qkv": (d, 3 * d)} if geom["fused_qkv"] else
             {"q": (d, d), "k": (d, d), "v": (d, d)})
    sites.update({"out": (d, d), "fc_in": (d, ff), "fc_out": (ff, d)})
    ln = lambda: {"scale": f32(1 + 0.1 * rng.normal(size=d)),
                  "bias": f32(0.1 * rng.normal(size=d))}
    params, quant = {}, {}
    for i in range(geom["n_layers"]):
        p, q = {"ln_1": ln(), "ln_2": ln(), "attn": {}}, {"attn": {}}
        for site, (K, N) in sites.items():
            w = f32(rng.normal(size=(K, N)) / np.sqrt(K))
            node = {"kernel": w, "bias": f32(bias_std * rng.normal(size=N))}
            a_alpha = np.float32(rng.uniform(1.5, 2.5))
            if kind == "ant":
                st = {"weight_q": np_state(0.9 * np.abs(w).max(0),
                                           cb.ant_grid("flint", 4, True)),
                      "input_q": np_state(a_alpha,
                                          cb.ant_grid("flint", 4, False))}
            elif kind == "olive":
                mode = "int" if site in ("qkv", "q", "k", "v") else "flint"
                st = {"weight_q": np_state(
                          2.5 * w.std(0), cb.olive_grid(mode, 4, True),
                          cb.olive_outlier_values(4, True)),
                      "input_q": np_state(
                          a_alpha, cb.olive_grid("flint", 4, True),
                          cb.olive_outlier_values(4, True))}
            attn = site in ("qkv", "q", "k", "v", "out")
            (p["attn"] if attn else p)[site] = node
            if kind in ("ant", "olive"):
                (q["attn"] if attn else q)[site] = st
        params[f"h_{i}"], quant[f"h_{i}"] = p, q
    params["wte"] = {"embedding": f32(rng.normal(size=(V, d)))}
    if geom["positions"] != "alibi":
        params["wpe"] = {"embedding": f32(
            0.3 * rng.normal(size=(geom["max_seq"] + 2, d)))}
    params["ln_f"] = ln()
    return params, (quant if kind in ("ant", "olive") else None)


def engine_inputs(case: str) -> np.ndarray:
    B, T = ENGINE_CASES[case][4]
    return np.random.default_rng(0).integers(0, 96, (B, T))


def _port_config(case: str):
    from ant_quantization_tpu_torch.models.transformer_lm import (
        LMConfig, TransformerLM, tp_logits)
    from ant_quantization_tpu_torch.serve.engine import EngineConfig
    geom_kw, _, eng_kw, _, _, _ = ENGINE_CASES[case]
    return EngineConfig(lm=LMConfig(**_geom(**geom_kw)), dtype=torch.float32,
                        **{**ENGINE_DEFAULTS, **eng_kw})


def _collectives(fn) -> tuple:
    """(result, {c10d op: count}) of ``fn()`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    counts = {e.key: e.count for e in prof.key_averages()
              if e.key.startswith("c10d::")}
    return res, counts


def engine_case(case: str) -> dict:
    from ant_quantization_tpu_torch.parallel.mesh import (
        P, axis_group, axis_index, local_shard, make_mesh)
    from ant_quantization_tpu_torch.serve import engine as eng
    from ant_quantization_tpu_torch.serve import sharded as sh
    geom_kw, kind, _, (dp, tp), _, what = ENGINE_CASES[case]
    # a (dp, tp) mesh with the rest of the world as a replica axis that no
    # spec names: ranks [0, dp * tp) are the case's mesh
    mesh = make_mesh((WORLD // (dp * tp), dp, tp), ("rep", "dp", "tp"))
    cfg = _port_config(case)
    params, quant = engine_model(_geom(**geom_kw), kind)
    ep = eng.build_engine_params(cfg, params, quant, device="cpu")
    tcfg = sh.tp_engine_config(cfg, mesh)
    eps = sh.shard_engine_params(ep, tcfg, mesh)
    fwd = sh.make_sharded_forward(tcfg, mesh)
    ids = torch.as_tensor(engine_inputs(case))
    B = ids.shape[0]
    rows = local_shard(ids, mesh, P("dp", None))
    res = {"dp_index": axis_index(mesh, "dp"),
           "tp_index": axis_index(mesh, "tp")}
    fresh = lambda: sh.shard_cache(eng.init_cache(cfg, B, device="cpu"),
                                   mesh)
    with torch.no_grad():
        if what == "batcher":
            from ant_quantization_tpu_torch.serve.scheduler import (
                ContinuousBatcher, Request)
            kv = sh.shard_cache(eng.init_cache(cfg, 2, device="cpu"), mesh)
            cbat = ContinuousBatcher(tcfg, eps, batch_slots=2,
                                     prefill_buckets=(8,), forward_fn=fwd,
                                     kv=kv)
            for prompt, n in BATCHER_REQUESTS:
                cbat.submit(Request(prompt=prompt, max_new_tokens=n))
            done = cbat.run()
            res["completions"] = {c.id: c.tokens for c in done}
            return res
        if what in ("sp", "sp_last"):
            li = (torch.as_tensor(SP_LAST_INDEX) if what == "sp_last"
                  else None)
            res["sp_gate"] = eng._sp_gate(tcfg, eps, *rows.shape,
                                          axis_group(mesh, "tp"))
            (logits, kv), res["prefill_collectives"] = _collectives(
                lambda: fwd(eps, rows, fresh(), 0, li))
            # the port's single-device prefill on the same weights
            kv1 = eng.init_cache(cfg, B, device="cpu")
            want, _ = eng.forward(cfg, ep, ids, kv1, 0, last_index=li)
            res["single_logits"] = want
            res["single_cache_local"] = tuple(sh.shard_cache(kv1, mesh))
            res["cache_local"] = tuple(t.clone() for t in kv)
            res["logits"] = logits
            if what == "sp" and kind == "ant":
                tok = logits[:, -1:].argmax(-1)
                _, res["decode_collectives"] = _collectives(
                    lambda: fwd(eps, tok, kv, rows.shape[1]))
            return res
        logits, kv = fwd(eps, rows, fresh(), 0)
        res["logits"] = logits
        res["cache_written"] = int(kv.k.to(torch.int32).abs().sum())
        if what == "decode":
            tok = logits[:, -1:].argmax(-1)
            res["decode_logits"], _ = fwd(eps, tok, kv, rows.shape[1])
    return res


def engine_cases() -> dict:
    return {case: engine_case(case) for case in ENGINE_CASES}


# ---------------------------------------------------------------------------
# the tensor-parallel TransformerLM and the runtime helpers
# ---------------------------------------------------------------------------

LM_GEOM = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
               max_seq=64)
# case: (LMConfig changes, states kind, mesh (dp, tp))
LM_CASES = {
    "olive-fused-dp2-tp2": ({}, "olive", (2, 2)),
    "olive-fused-dp1-tp4": ({}, "olive", (1, 4)),
    "float-split-alibi": (dict(fused_qkv=False, positions="alibi",
                               activation="gelu"), "float", (1, 4)),
    "ant-split-untied": (dict(fused_qkv=False, positions="learned_offset2",
                              activation="relu", tie_word_embeddings=False),
                         "ant", (2, 2)),
    "ant-conv1d": (dict(conv1d_sites=True), "ant", (1, 4)),
}
LM_BATCH = (4, 16)


def lm_geom(case: str) -> dict:
    return {**LM_GEOM, "positions": "learned", "activation": "gelu_new",
            "fused_qkv": True, **LM_CASES[case][0]}


def lm_model(case: str):
    """The model's params tree (the reference's layout and table sizes)
    and quant tree of numpy states; a Conv1D model's weight states run
    along the input axis."""
    geom = lm_geom(case)
    kind = LM_CASES[case][1]
    eg = {k: geom[k] for k in ("vocab_size", "d_model", "n_layers",
                               "d_ff", "max_seq", "positions",
                               "fused_qkv")}
    params, quant = engine_model(eg, kind, seed=3)
    rng = np.random.default_rng(4)
    if geom["positions"] == "learned":
        params["wpe"]["embedding"] = params["wpe"]["embedding"][
            :geom["max_seq"]]
    if not geom.get("tie_word_embeddings", True):
        params["lm_head"] = {"kernel": (rng.normal(size=(
            geom["d_model"], geom["vocab_size"])) / 8).astype(np.float32)}
    if geom.get("conv1d_sites") and quant:
        for i in range(geom["n_layers"]):
            p, q = params[f"h_{i}"], quant[f"h_{i}"]
            for node, qn in [(p["attn"][s], q["attn"][s])
                             for s in p["attn"]] + [
                    (p[s], q[s]) for s in ("fc_in", "fc_out")]:
                qn["weight_q"]["alpha"] = (0.9 * np.abs(
                    node["kernel"]).max(1)).astype(np.float32)
    return params, quant


def lm_inputs() -> np.ndarray:
    return np.random.default_rng(5).integers(0, LM_GEOM["vocab_size"],
                                             LM_BATCH)


def _port_states(tree):
    from ant_quantization_tpu_torch.calibrate.spec import QuantState
    if isinstance(tree, dict) and "alpha" in tree:
        return QuantState(**{k: torch.as_tensor(np.asarray(v))
                             for k, v in tree.items()})
    return {k: _port_states(v) for k, v in tree.items()}


def lm_cases() -> dict:
    """The sharded TransformerLM forward of every case, and the runtime's
    host helpers, on a world of two hosts of two ranks."""
    from ant_quantization_tpu_torch.models.transformer_lm import (
        LMConfig, TransformerLM, tp_logits)
    from ant_quantization_tpu_torch.nn.config import QuantConfig
    from ant_quantization_tpu_torch.parallel import distributed as rt
    from ant_quantization_tpu_torch.parallel.mesh import (
        LM_PARAM_RULES, LM_QUANT_RULES, P, axis_group, axis_index,
        local_shard, make_mesh, shard_pytree)
    out = {}
    hybrid = rt.make_hybrid_mesh()
    ids = lm_inputs()
    host, n_hosts = rt.process_shard()
    per = ids.shape[0] // n_hosts
    out["process_shard"] = (host, n_hosts)
    out["host_rows"] = rt.host_batch_to_global(
        ids[host * per:(host + 1) * per], hybrid, P("dp", None))
    out["hybrid_shape"] = tuple(hybrid.shape)
    quant_cfgs = {
        "olive": QuantConfig(mode="ant-int-flint", family="olive",
                             w_low=100, w_up=101, a_low=100, a_up=101),
        "ant": QuantConfig(mode="flint", family="ant", w_low=100,
                           w_up=101, a_low=100, a_up=101),
        "float": QuantConfig(enabled=False)}
    for case, (_, kind, (dp, tp)) in LM_CASES.items():
        mesh = hybrid if (dp, tp) == (2, 2) else make_mesh((dp, tp))
        cfg = LMConfig(**lm_geom(case))
        params, quant = lm_model(case)
        p = shard_pytree(params, mesh, LM_PARAM_RULES)
        q = shard_pytree(_port_states(quant), mesh,
                         LM_QUANT_RULES + LM_PARAM_RULES) if quant else None
        rows = local_shard(torch.as_tensor(ids), mesh, P("dp", None))
        model = TransformerLM(cfg, quant_cfgs[kind], device="cpu")
        with torch.no_grad():
            logits = tp_logits(model, p, q, rows, axis_group(mesh, "tp"))
        out[case] = {"logits": logits, "dp_index": axis_index(mesh, "dp"),
                     "tp_index": axis_index(mesh, "tp")}
    return out


def unreachable():
    """A rank body that must not run (its world is refused first)."""
    raise AssertionError("a refused world started")

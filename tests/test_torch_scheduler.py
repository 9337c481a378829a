"""PyTorch port vs the JAX reference: continuous batching
(``serve/scheduler.py``) on a dense engine (``weight_mode="bf16"``, f32,
the bf16 cache or INT8 KV) at the reference tests' size: completions equal
to independent generation, eos freeing a slot, chunked ticks equal to
per-tick ticks, a forward function without ``last_index``, sampling with
top-k 1 equal to greedy, and greedy tokens equal to the JAX
``ContinuousBatcher``'s on the same converted params."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.models.transformer_lm import LMConfig as JLMConfig
from ant_quantization_tpu.serve import engine as jeng
from ant_quantization_tpu.serve import scheduler as jsch
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.models.transformer_lm import LMConfig
from ant_quantization_tpu_torch.serve import engine as teng
from ant_quantization_tpu_torch.serve.sampling import SamplingConfig
from ant_quantization_tpu_torch.serve.scheduler import (ContinuousBatcher,
                                                        Request, _bucket)

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

GEOM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            max_seq=96, positions="learned", activation="gelu_new",
            fused_qkv=True)


def tiny_params(geom: dict, seed: int) -> dict:
    """Random float weights of a fused-qkv decoder in the reference
    model's tree (numpy leaves)."""
    rng = np.random.default_rng(seed)
    d, ff, V = geom["d_model"], geom["d_ff"], geom["vocab_size"]
    f32 = lambda a: np.asarray(a, np.float32)
    lin = lambda K, N: {"kernel": f32(rng.normal(size=(K, N)) / np.sqrt(K)),
                        "bias": f32(0.05 * rng.normal(size=N))}
    ln = lambda: {"scale": f32(1 + 0.1 * rng.normal(size=d)),
                  "bias": f32(0.1 * rng.normal(size=d))}
    params = {f"h_{i}": {"ln_1": ln(), "ln_2": ln(),
                         "attn": {"qkv": lin(d, 3 * d), "out": lin(d, d)},
                         "fc_in": lin(d, ff), "fc_out": lin(ff, d)}
              for i in range(geom["n_layers"])}
    params["wte"] = {"embedding": f32(0.5 * rng.normal(size=(V, d)))}
    params["wpe"] = {"embedding": f32(0.1 * rng.normal(
        size=(geom["max_seq"] + 2, d)))}
    params["ln_f"] = ln()
    return params


def engines(geom: dict, params, **kw):
    """The same dense engine for both: (jcfg, jep, tcfg, tep), the port's
    converted from the reference's tree. f32; ``params`` is a model tree
    or the seed of :func:`tiny_params`; ``kw`` overrides the
    EngineConfig fields (kv_int8, lm_head_int8, ...)."""
    if isinstance(params, int):
        params = tiny_params(geom, params)
    kw = dict(dict(weight_mode="bf16", act_bits=0, kv_int8=False,
                   max_seq=geom["max_seq"]), **kw)
    jcfg = jeng.EngineConfig(lm=JLMConfig(**geom), dtype=jnp.float32,
                             interpret=True, **kw)
    tcfg = teng.EngineConfig(lm=LMConfig(**geom), dtype=torch.float32, **kw)
    jep = jeng.build_engine_params(jcfg, params)
    tep = convert.from_jax_engine_params(
        jax.tree_util.tree_map(np.asarray, jep), device="cpu")
    return jcfg, jep, tcfg, tep


def generate_alone(cfg, ep, prompt, n_new):
    """Greedy generation of one request alone: batch 1, no padding."""
    kv = teng.init_cache(cfg, 1, device="cpu")
    ids = torch.tensor([prompt])
    logits, kv = teng.forward(cfg, ep, ids, kv, 0)
    out = [int(logits[0, -1].argmax())]
    for i in range(n_new - 1):
        logits, kv = teng.forward(cfg, ep, torch.tensor([[out[-1]]]), kv,
                                  len(prompt) + i)
        out.append(int(logits[0, -1].argmax()))
    return out


@pytest.fixture(scope="module")
def setup():
    return engines(GEOM, 0)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_matches_independent_generation(setup, kv_int8):
    _, _, tcfg, tep = setup
    tcfg = dataclasses.replace(tcfg, kv_int8=kv_int8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 64, n).tolist() for n in (5, 11, 3, 17, 8)]
    n_new = 6
    refs = [generate_alone(tcfg, tep, p, n_new) for p in prompts]
    cb = ContinuousBatcher(tcfg, tep, batch_slots=2,
                           prefill_buckets=(8, 32), pad_id=0)
    assert cb.kv.k.dtype == (torch.int8 if kv_int8 else torch.float32)
    ids = [cb.submit(Request(prompt=p, max_new_tokens=n_new))
           for p in prompts]
    done = cb.run()
    assert len(done) == len(prompts) and cb.n_active == 0
    by_id = {c.id: c for c in done}
    for rid, ref, p in zip(ids, refs, prompts):
        assert by_id[rid].tokens == ref, (p, by_id[rid].tokens, ref)
        assert by_id[rid].finish_reason == "length"


def test_eos_frees_slot_early(setup):
    _, _, tcfg, tep = setup
    probe = [5, 9, 2]
    first = generate_alone(tcfg, tep, probe, 1)[0]
    cb = ContinuousBatcher(tcfg, tep, batch_slots=1, prefill_buckets=(8,))
    rid = cb.submit(Request(prompt=probe, max_new_tokens=10, eos_id=first))
    rid2 = cb.submit(Request(prompt=[7, 7], max_new_tokens=2))
    by_id = {c.id: c for c in cb.run()}
    assert by_id[rid].finish_reason == "eos"
    assert by_id[rid].tokens == [first]
    assert len(by_id[rid2].tokens) == 2      # the queued request got the slot


def test_chunked_ticks_match_per_tick(setup):
    """run(ticks_per_dispatch=4) completes every request with the tokens
    of per-tick stepping, across completions within a chunk, refills and
    an eos stop; a finished slot's stale length passes the end of the
    cache within a chunk and is clamped."""
    _, _, tcfg, tep = setup
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 64, n).tolist() for n in (5, 11, 3, 9, 7, 4)]
    lens = [6, 3, 9, 5, 7, 2]

    def run(tpd, cfg=tcfg):
        cb = ContinuousBatcher(cfg, tep, batch_slots=2,
                               prefill_buckets=(8, 16), pad_id=0)
        ids = [cb.submit(Request(prompt=p, max_new_tokens=n))
               for p, n in zip(prompts, lens)]
        return ids, {c.id: c.tokens for c in cb.run(ticks_per_dispatch=tpd)}

    ids1, per_tick = run(1)
    ids4, chunked = run(4)
    assert ids1 == ids4 and per_tick == chunked
    ref = generate_alone(tcfg, tep, prompts[0], 8)
    eos = ref[3]
    cb = ContinuousBatcher(tcfg, tep, batch_slots=1, prefill_buckets=(8,))
    cb.submit(Request(prompt=prompts[0], max_new_tokens=8, eos_id=eos))
    done = cb.run(ticks_per_dispatch=4)
    assert done[0].finish_reason == "eos"
    assert done[0].tokens == ref[:ref.index(eos) + 1]
    # a short cache: requests end at max_seq, the free slot's clamped
    short = dataclasses.replace(tcfg, max_seq=24)
    cb = ContinuousBatcher(short, tep, batch_slots=2, prefill_buckets=(16,))
    cb.submit(Request(prompt=prompts[1], max_new_tokens=40))
    cb.submit(Request(prompt=prompts[2], max_new_tokens=2))
    done = {c.prompt[0]: c for c in cb.run(ticks_per_dispatch=8)}
    assert done[prompts[1][0]].finish_reason == "length"
    assert len(prompts[1]) + len(done[prompts[1][0]].tokens) == 24


def test_legacy_forward_fn_without_last_index(setup):
    """A forward function with the old 4-argument signature: the batcher
    takes the padded prompt's logits at the last real position itself."""
    _, _, tcfg, tep = setup
    prompt, n_new = [3, 1, 4, 1, 5], 6
    calls = []

    def legacy(ep_, ids_, kv_, pos0_):
        calls.append(ids_.shape)
        return teng.forward(tcfg, ep_, ids_, kv_, pos0_)

    out = {}
    for fwd in (None, legacy):
        cb = ContinuousBatcher(tcfg, tep, batch_slots=1,
                               prefill_buckets=(8,), forward_fn=fwd)
        cb.submit(Request(prompt=prompt, max_new_tokens=n_new))
        out[fwd is None] = cb.run()[0].tokens
    assert calls[0] == (1, 8)
    assert out[True] == out[False] == generate_alone(tcfg, tep, prompt,
                                                     n_new)


def test_sampling_topk1_equals_greedy_and_seeds(setup):
    _, _, tcfg, tep = setup
    prompts = [[1, 2, 3], [4, 5], [6]]

    def run(sampling, seed=0, slots=2, n=5):
        cb = ContinuousBatcher(tcfg, tep, batch_slots=slots,
                               prefill_buckets=(8,), sampling=sampling,
                               seed=seed)
        for p in prompts[:3 if slots > 1 else 1]:
            cb.submit(Request(prompt=p, max_new_tokens=n))
        return {c.id: c.tokens for c in cb.run()}

    assert run(None) == run(SamplingConfig(temperature=1.0, top_k=1))
    hot = SamplingConfig(temperature=2.0)
    outs = {tuple(run(hot, seed=s, slots=1, n=8)[0]) for s in range(4)}
    assert len(outs) > 1, "temperature 2 should vary across seeds"
    assert run(hot, seed=1, slots=1, n=8) == run(hot, seed=1, slots=1, n=8)


def test_bucket():
    assert _bucket(1, (8, 32)) == 8 and _bucket(9, (8, 32)) == 32
    with pytest.raises(ValueError, match="largest bucket"):
        _bucket(33, (8, 32))


@pytest.mark.parametrize("kv_int8", [False, True])
def test_greedy_tokens_equal_reference_batcher(setup, kv_int8):
    """The same request stream through the JAX ContinuousBatcher and the
    port's, on the same converted params: identical greedy tokens (the
    logits agree within 1e-5 here, far inside every argmax margin)."""
    jcfg, jep, tcfg, tep = setup
    jcfg = dataclasses.replace(jcfg, kv_int8=kv_int8)
    tcfg = dataclasses.replace(tcfg, kv_int8=kv_int8)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 64, n).tolist() for n in (6, 13, 2, 9, 20)]
    lens = [5, 8, 3, 6, 4]
    out = {}
    for mod, cfg, ep in ((jsch, jcfg, jep), (None, tcfg, tep)):
        cls = mod.ContinuousBatcher if mod else ContinuousBatcher
        req = mod.Request if mod else Request
        cb = cls(cfg, ep, batch_slots=3, prefill_buckets=(8, 32))
        for p, n in zip(prompts, lens):
            cb.submit(req(prompt=p, max_new_tokens=n, eos_id=None))
        out[mod is None] = {c.id: (c.tokens, c.finish_reason)
                            for c in cb.run(ticks_per_dispatch=2)}
    assert out[True] == out[False]

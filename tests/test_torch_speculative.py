"""PyTorch port vs the JAX reference: speculative decoding
(``serve/speculative.py``) on the reference tests' engines (dense, f32,
INT8 KV, the JAX model's initialisation; target 2 layers of 32, draft 1
layer of 16, k 3).
Greedy draft-and-verify emits the target's own greedy stream, token for
token, and the JAX decoder's stream on the same converted params;
rejection sampling is held to its distribution."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.models.transformer_lm import LMConfig as JLMConfig
from ant_quantization_tpu.models.transformer_lm import TransformerLM
from ant_quantization_tpu.nn.config import QuantConfig
from ant_quantization_tpu.serve import speculative as jspec
from ant_quantization_tpu_torch.serve import engine as teng
from ant_quantization_tpu_torch.serve.sampling import (SamplingConfig,
                                                       filtered_log_probs)
from ant_quantization_tpu_torch.serve.speculative import SpeculativeDecoder

import test_torch_scheduler as sch

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep


def _mk(vocab, n_layers, d_model, seed, **kw):
    """The reference test's engines: the JAX model's own initialisation
    (its tied embedding and layers give varied greedy streams), a dense
    f32 engine with INT8 KV built by the JAX package, and the port's
    converted from it -> (jcfg, jep, tcfg, tep)."""
    geom = dict(sch.GEOM, vocab_size=vocab, n_layers=n_layers,
                d_model=d_model, d_ff=2 * d_model, max_seq=64)
    model = TransformerLM(JLMConfig(**geom), QuantConfig(enabled=False))
    ids = jnp.asarray(np.random.default_rng(seed).integers(0, vocab, (2, 8)))
    params = model.init(jax.random.PRNGKey(seed), ids)["params"]
    return sch.engines(geom, params, kv_int8=True, **kw)


def greedy_alone(cfg, ep, prompt, n):
    """The target decoding alone, one token a step -> (B, n)."""
    B, T = prompt.shape
    kv = teng.init_cache(cfg, B, device="cpu")
    logits, kv = teng.forward(cfg, ep, torch.as_tensor(prompt), kv, 0)
    tok = logits[:, -1:].argmax(-1)
    out = [tok[:, 0]]
    for i in range(n - 1):
        logits, kv = teng.forward(cfg, ep, tok, kv, T + i)
        tok = logits[:, -1:].argmax(-1)
        out.append(tok[:, 0])
    return torch.stack(out, 1).numpy()


def test_speculative_matches_target_greedy_and_reference():
    """The emitted stream is the target's greedy stream, and the JAX
    SpeculativeDecoder's on the same params."""
    jt, jtep, tt, ttep = _mk(64, 2, 32, seed=0)
    jd, jdep, td, tdep = _mk(64, 1, 16, seed=1)
    prompt = np.random.default_rng(2).integers(0, 64, (2, 6))
    n = 12
    want = greedy_alone(tt, ttep, prompt, n)
    spec = SpeculativeDecoder(tt, ttep, td, tdep, k=3)
    got = spec.generate(prompt, n)
    assert [len(g) for g in got] == [n, n]
    np.testing.assert_array_equal(np.asarray(got), want)
    ref = jspec.SpeculativeDecoder(jt, jtep, jd, jdep, k=3).generate(
        prompt, n)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert len(spec.accepted_hist) >= 1


def test_speculative_accepts_everything_when_draft_is_target():
    """Draft = target (one params tree, two caches): every proposal is
    accepted, k per round and sequence, and the stream is plain greedy."""
    _, _, tt, ttep = _mk(64, 2, 32, seed=0)
    prompt = np.random.default_rng(3).integers(0, 64, (2, 4))
    spec = SpeculativeDecoder(tt, ttep, tt, ttep, k=3)
    got = spec.generate(prompt, 10)
    np.testing.assert_array_equal(np.asarray(got),
                                  greedy_alone(tt, ttep, prompt, 10))
    assert spec.accepted_hist, "no rounds ran"
    assert all(a == 3 * 2 for a in spec.accepted_hist), spec.accepted_hist


def test_speculative_lossless_with_lm_head_int8():
    """The int8 head's per-token scale keeps a token's logits independent
    of the verify window, so the stream stays the target's."""
    _, _, tt, ttep = _mk(64, 2, 32, seed=0, lm_head_int8=True)
    _, _, td, tdep = _mk(64, 1, 16, seed=1)
    prompt = np.random.default_rng(5).integers(0, 64, (2, 6))
    got = SpeculativeDecoder(tt, ttep, td, tdep, k=3).generate(prompt, 12)
    np.testing.assert_array_equal(np.asarray(got),
                                  greedy_alone(tt, ttep, prompt, 12))


def test_speculative_eos_truncation():
    _, _, tt, ttep = _mk(64, 2, 32, seed=0)
    _, _, td, tdep = _mk(64, 1, 16, seed=1)
    prompt = np.random.default_rng(2).integers(0, 64, (2, 6))
    want = greedy_alone(tt, ttep, prompt, 12)
    # a sequence and an eos whose first occurrence is mid-stream
    b, j = next((b, j) for b in range(2) for j in range(1, 12)
                if want[b, j] not in want[b, :j])
    eos = int(want[b, j])
    got = SpeculativeDecoder(tt, ttep, td, tdep, k=3).generate(
        prompt, 12, eos_id=eos)
    assert got[b] == list(want[b, :j + 1])
    other = 1 - b
    if eos in list(want[other]):
        assert got[other][-1] == eos
    else:
        assert got[other] == list(want[other])


def test_speculative_rounds_per_dispatch_invariant():
    """Rounds grouped 1 or 3 per call emit the same stream, greedy and
    sampled (each round draws from its absolute round's seed)."""
    _, _, tt, ttep = _mk(64, 2, 32, seed=0)
    _, _, td, tdep = _mk(64, 1, 16, seed=1)
    prompt = np.random.default_rng(7).integers(0, 64, (2, 5))
    for scfg in (None, SamplingConfig(temperature=0.9, top_k=8)):
        outs = [SpeculativeDecoder(tt, ttep, td, tdep, k=3, sampling=scfg,
                                   seed=11).generate(
                    prompt, 10, rounds_per_dispatch=rpd)
                for rpd in (1, 3)]
        np.testing.assert_array_equal(np.asarray(outs[0]),
                                      np.asarray(outs[1]))


def test_rejection_sampling_topk1_equals_greedy():
    _, _, tt, ttep = _mk(64, 2, 32, seed=0)
    _, _, td, tdep = _mk(64, 1, 16, seed=1)
    prompt = np.random.default_rng(2).integers(0, 64, (2, 6))
    greedy = SpeculativeDecoder(tt, ttep, td, tdep, k=3).generate(prompt, 10)
    topk1 = SpeculativeDecoder(
        tt, ttep, td, tdep, k=3,
        sampling=SamplingConfig(temperature=1.0, top_k=1)).generate(
            prompt, 10)
    np.testing.assert_array_equal(np.asarray(greedy), np.asarray(topk1))


def test_rejection_sampling_is_lossless():
    """The first token of a rejection-sampling round follows the target's
    filtered distribution, whatever the draft: total variation from the
    target's exact p_0 below the reference test's 0.12 over 640 draws."""
    vocab = 16
    _, _, tt, ttep = _mk(vocab, 2, 32, seed=0)
    _, _, td, tdep = _mk(vocab, 1, 16, seed=7)     # an unrelated draft
    scfg = SamplingConfig(temperature=1.5)
    spec = SpeculativeDecoder(tt, ttep, td, tdep, k=3, sampling=scfg)
    B = 32
    prompt = torch.as_tensor(np.tile(np.asarray([[3, 1, 4]]), (B, 1)))
    last = torch.full((B, 1), 2, dtype=torch.int64)
    kv_t = teng.init_cache(tt, B, device="cpu")
    kv_d = teng.init_cache(td, B, device="cpu")
    teng.forward(td, tdep, prompt, kv_d, 0)
    teng.forward(tt, ttep, prompt, kv_t, 0)
    # the exact target distribution after [prompt, last]
    ref = teng.init_cache(tt, B, device="cpu")
    teng.forward(tt, ttep, prompt, ref, 0)
    lt, _ = teng.forward(tt, ttep, last, ref, 3)
    p0 = np.exp(filtered_log_probs(lt[:, -1], scfg).numpy())[0]
    pos = np.full((B,), 3, np.int64)
    counts = np.zeros(vocab)
    for r in range(20):
        # every round rewrites rows 3..3+k of both caches before it reads
        # them, so the caches serve every round as they were
        out, _, _ = spec.step(kv_t, kv_d, last, pos, spec._round_gen(100 + r))
        counts += np.bincount(out[:, 0].numpy(), minlength=vocab)
    freq = counts / counts.sum()
    tv = 0.5 * np.abs(freq - p0).sum()
    assert tv < 0.12, (tv, freq, p0)

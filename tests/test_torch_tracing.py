"""The port's own spans and counters (``utils/profiling.py``) and where
the serving path records them.

- Off: ``span`` returns one shared null context and nothing is kept.
- On, under ``recording()`` and under ``torch.profiler.profile``: the
  records nest, with their parents and keys; the buffer keeps the newest
  records and counts the ones it let go.
- A tiny ANT W4A4 OPT and BLOOM behind ``ContinuousBatcher``: each
  ``batcher.dispatch`` holds its ticks, each tick one ``engine.forward``
  with ``n_layers`` ``kv.append`` spans, ``kv.copies`` is 4 B L a tick
  on the CPU (the plain append's indexed copies, each under its four
  ``host.sync`` constants), and greedy tokens are the same with
  recording on and off.
- On a card (marker ``cuda``): one decode dispatch raises exactly as
  many synchronizing-call warnings under
  ``torch.cuda.set_sync_debug_mode("warn")`` as it records ``host.sync``
  spans; its ticks record ``kv.copies`` = L (one KV append launch a
  layer) and no ``host.sync`` under ``kv.append``. This file imports no
  JAX; on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import collections
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ant_quantization_tpu_torch.models.transformer_lm import LMConfig
from ant_quantization_tpu_torch.serve import engine as eng
from ant_quantization_tpu_torch.serve.scheduler import (ContinuousBatcher,
                                                        Request)
from ant_quantization_tpu_torch.tools.lm_bench import rand_engine_params
from ant_quantization_tpu_torch.utils import profiling

pytestmark = pytest.mark.torchdep

FAMILIES = {
    "opt": dict(positions="learned_offset2", activation="relu",
                fused_qkv=False),
    "bloom": dict(positions="alibi", activation="gelu", fused_qkv=True,
                  embed_ln=True),
}
SLOTS, TICKS = 3, 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as ``test_torch_engine.one_torch_thread``
    (which this file does not import: that module imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh(monkeypatch):
    """An empty recorder of its own for the test."""
    rec = profiling._Recorder()
    monkeypatch.setattr(profiling, "_REC", rec)
    return rec


def test_off_records_nothing(fresh):
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("a"), profiling.span("b", key=3)
    assert a is b is profiling._NULL
    with a:
        with b:
            profiling.count("c", 4)
    assert profiling.records() == [] and profiling.counts() == []
    assert profiling.dropped() == (0, 0)


def _nest():
    with profiling.span("outer", key=7):
        with profiling.span("inner"):
            profiling.count("n", 2)
        with profiling.span("second", key="r"):
            pass
    profiling.count("top", 1)


@pytest.mark.parametrize("switch", ["recording", "profiler"])
def test_on_records_nesting_parents_and_keys(fresh, switch):
    if switch == "recording":
        with profiling.recording():
            _nest()
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            _nest()
    recs = profiling.records()
    assert [(n, p, k) for n, _, _, p, k in recs] == [
        ("outer", None, 7), ("inner", 0, None), ("second", 0, "r")]
    (_, s0, e0, _, _), (_, s1, e1, _, _), (_, s2, e2, _, _) = recs
    assert s0 <= s1 <= e1 <= s2 <= e2 <= e0
    assert [(n, c, p) for n, c, _, p in profiling.counts()] == [
        ("n", 2, 1), ("top", 1, None)]
    assert profiling.records() == recs          # reading keeps them
    # off again: nothing more is kept
    _nest()
    assert len(profiling.records()) == 3 and len(profiling.counts()) == 2


def test_buffer_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "_REC", profiling._Recorder(4))
    with profiling.recording():
        with profiling.span("root"):
            for i in range(5):
                with profiling.span("leaf", key=i):
                    profiling.count("c", i)
    recs = profiling.records()
    assert [k for _, _, _, _, k in recs] == [1, 2, 3, 4]
    # the root was dropped: its children read as top-level spans
    assert all(p is None for _, _, _, p, _ in recs)
    assert [(c, p) for _, c, _, p in profiling.counts()] == [
        (1, 0), (2, 1), (3, 2), (4, 3)]
    assert profiling.dropped() == (2, 1)
    profiling.clear()
    assert profiling.records() == [] and profiling.dropped() == (0, 0)


def tiny_engine(family: str, device="cpu", d_model=64, d_ff=128,
                n_heads=2):
    lm = LMConfig(vocab_size=256, d_model=d_model, n_layers=2,
                  n_heads=n_heads, d_ff=d_ff, max_seq=96,
                  **FAMILIES[family])
    cfg = eng.EngineConfig(lm=lm, weight_mode="w4", act_bits=4,
                           kv_int8=True, lm_head_int8=True, max_seq=96,
                           dtype=torch.float32)
    return cfg, rand_engine_params(cfg, 11, device)


def serve(cfg, ep, chunks: int):
    """Three requests that outlast ``chunks`` dispatches of ``TICKS``
    ticks; returns their tokens so far."""
    b = ContinuousBatcher(cfg, ep, SLOTS, prefill_buckets=(16, 32))
    for i, n in enumerate((5, 12, 20)):
        b.submit(Request(prompt=[(7 * i + j) % 256 for j in range(n)],
                         max_new_tokens=64))
    for _ in range(chunks):
        assert b.step_chunk(TICKS) == []
    return [list(t) for t in b.slot_tokens]


def _children(recs, i):
    return [j for j, r in enumerate(recs) if r[3] == i]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batcher_records_its_ticks(fresh, family):
    cfg, ep = tiny_engine(family)
    L, chunks = cfg.lm.n_layers, 2
    plain = serve(cfg, ep, chunks)
    with profiling.recording():
        traced = serve(cfg, ep, chunks)
    assert traced == plain                         # greedy, on and off
    recs = profiling.records()
    names = collections.Counter(n for n, *_ in recs)
    assert names["batcher.prefill"] == 3 and names["batcher.slot_copy"] == 3
    prefills = [r for r in recs if r[0] == "batcher.prefill"]
    assert [k for *_, k in prefills] == [0, 1, 2]  # request ids
    dispatches = [i for i, r in enumerate(recs)
                  if r[0] == "batcher.dispatch"]
    assert len(dispatches) == chunks
    ticks = []
    for d in dispatches:
        kids = [recs[j][0] for j in _children(recs, d)]
        assert kids.count("batcher.tick") == TICKS
        assert kids.count("batcher.apply") == TICKS
        assert kids.count("host.sync") == 2       # tokens in, tokens out
        ticks += [j for j in _children(recs, d)
                  if recs[j][0] == "batcher.tick"]
    # absolute ticks: each prefill drew one, then the chunks' ticks
    assert [recs[t][4] for t in ticks] == list(range(3, 3 + chunks * TICKS))
    copies = {p: c for n, c, _, p in profiling.counts() if n == "kv.copies"}
    for t in ticks:
        (fwd,) = _children(recs, t)
        assert recs[fwd][0] == "engine.forward"
        appends = [j for j in _children(recs, fwd)
                   if recs[j][0] == "kv.append"]
        assert len(appends) == L
        assert sum(copies[j] for j in appends) == 4 * SLOTS * L
        inner = collections.Counter(recs[j][0] for j in _children(recs, fwd))
        launches = (5 if cfg.lm.fused_qkv else 7) * L   # sites and K2
        assert inner["kernel.launch"] == launches
        assert inner["engine.head"] == 1
        # the positions, the ALiBi slopes, and two GELU constants a layer
        want = 1 + (1 + 2 * L if family == "bloom" else 0)
        assert inner["host.sync"] == want
        for j in appends:
            assert [recs[k][0] for k in _children(recs, j)] == \
                ["host.sync"] * 4


def _warm_card_batcher(family: str):
    """A tiny engine's batcher on the card, every slot busy, after one
    dispatch that builds the kernels and warms."""
    cfg, ep = tiny_engine(family, "cuda", d_model=256, d_ff=512)
    b = ContinuousBatcher(cfg, ep, SLOTS, prefill_buckets=(16, 32))
    for n in (5, 12, 20):
        b.submit(Request(prompt=list(range(1, n + 1)), max_new_tokens=64))
    b.step_chunk(TICKS)
    torch.cuda.synchronize()
    return cfg, b


@pytest.mark.cuda
def test_host_syncs_are_the_cards_synchronizing_calls():
    """Under the sync debug mode torch warns at each call that waits for
    the card; a decode dispatch (every slot busy, nothing finishing)
    records exactly as many ``host.sync`` spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run there")
    for family in sorted(FAMILIES):
        cfg, b = _warm_card_batcher(family)
        profiling.clear()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen, \
                    profiling.recording():
                warnings.simplefilter("always")
                assert b.step_chunk(TICKS) == []
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in seen
                 if "synchronizing CUDA operation" in str(w.message)]
        spans = [r for r in profiling.records() if r[0] == "host.sync"]
        assert len(syncs) == len(spans), (family, len(syncs), len(spans),
                                          [str(w.message)[:200]
                                           for w in syncs[:3]])
        L = cfg.lm.n_layers
        # the positions and the head's constant; BLOOM's slopes and two
        # GELU constants a layer (the KV append waits for nothing)
        per_tick = 2 + (1 + 2 * L if family == "bloom" else 0)
        assert len(spans) == TICKS * per_tick + 2


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_card_decode_appends_once_a_layer(fresh, family):
    """On the card each decode tick writes the cache by one launch a
    layer: ``kv.copies`` = L a tick, each ``kv.append`` span without
    children (no wait, no ``kernel.launch``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run there")
    cfg, b = _warm_card_batcher(family)
    L = cfg.lm.n_layers
    with profiling.recording():
        assert b.step_chunk(TICKS) == []
    recs = profiling.records()
    ticks = [i for i, r in enumerate(recs) if r[0] == "batcher.tick"]
    copies = {p: c for n, c, _, p in profiling.counts() if n == "kv.copies"}
    assert len(ticks) == TICKS
    for t in ticks:
        (fwd,) = _children(recs, t)
        appends = [j for j in _children(recs, fwd)
                   if recs[j][0] == "kv.append"]
        assert len(appends) == L
        assert [copies[j] for j in appends] == [1] * L
        assert all(_children(recs, j) == [] for j in appends)

"""PyTorch port vs the JAX reference: INT8 KV quantize, stacked append
and dequantize. Codes and scales are compared bit-equal by position (the
reference's lane-folded layout is unfolded by convert.from_jax_kv).

The KV append kernel (``csrc/kv_append.cu``): its CUDA branch's launch
arguments on the CPU with a stand-in library, the engine's positional
call, and on a card (marker ``cuda``) the kernel's cache against the plain
version's, bit for bit, canaries included. The card's machine has no JAX,
so this file imports it only where it is present; there, without the
suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kv_cache.py
"""

import numpy as np
import pytest
import torch

try:        # absent on the card's machine, where only the cuda tests run
    import jax
    import jax.numpy as jnp
    from ant_quantization_tpu.kernels import kv_cache as jkv
except ImportError:
    jax = jnp = jkv = None

from ant_quantization_tpu_torch.convert import from_jax_kv
from ant_quantization_tpu_torch.kernels import kv_cache as tkv
from ant_quantization_tpu_torch.serve import engine as eng

from test_torch_tracing import one_torch_thread, tiny_engine  # noqa: F401

pytestmark = pytest.mark.torchdep


def test_quantize_bit_equal_with_zero_rows():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4, 7, 64)).astype(np.float32) * 3
    x[1, 2, 3] = 0.0                     # absmax 0 -> scale 1.0
    want_q, want_s = jkv._quantize(jnp.asarray(x))
    got_q, got_s = tkv.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[1, 2, 3] == 1.0


@pytest.mark.parametrize("head_dim", [128, 64])     # reference fold 1, 2
@pytest.mark.parametrize("T,index", [(1, 6), (5, 3), (5, 0)])
def test_append_stacked_bit_equal_by_position(head_dim, T, index):
    L, B, H, S, layer = 2, 2, 3, 12, 1
    rng = np.random.default_rng(head_dim + T + index)
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (L,) + a.shape),
        jkv.init_kv(B, S, H, head_dim))
    tcache = tkv.init_kv(L, B, S, H, head_dim, torch.device("cpu"))
    # two writes: the earlier positions must survive the later one
    for idx, t in ((0, index), (index, T)):
        if t == 0:
            continue
        k = rng.normal(size=(B, t, H, head_dim)).astype(np.float32)
        v = rng.normal(size=(B, t, H, head_dim)).astype(np.float32) * 2
        jcache = jkv.append_kv_stacked(jcache, jnp.asarray(k),
                                       jnp.asarray(v), layer, idx)
        tkv.append_kv_stacked(tcache, torch.from_numpy(k),
                              torch.from_numpy(v), layer, idx)
    want = from_jax_kv([np.asarray(a) for a in jcache], head_dim, "cpu")
    for g, w in zip(tcache, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    jk, jv = jkv.dequant_kv(jkv.QuantKV(*(a[layer] for a in jcache)),
                            jnp.float32)
    tk, tv = tkv.dequant_kv(tkv.QuantKV(*(a[layer] for a in tcache)),
                            torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("pos_vec", [False, True])
@pytest.mark.parametrize("head_dim,T", [(128, 5), (64, 1)])  # fold 1, 2
def test_append_stacked_per_sequence_bit_equal_by_position(head_dim, T,
                                                           pos_vec):
    """A (B,) write index: sequence b's rows go to index[b] .. index[b]+T-1
    (the reference's vector-index write), after a shared prefill write;
    with the positions also passed as ``pos_vec`` (sixth, positional, as
    the engine passes them) the CPU's plain path writes the same."""
    L, B, H, S, layer = 2, 3, 2, 16, 1
    rng = np.random.default_rng(head_dim + T)
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (L,) + a.shape),
        jkv.init_kv(B, S, H, head_dim))
    tcache = tkv.init_kv(L, B, S, H, head_dim, torch.device("cpu"))
    index = np.int32([7, 2, 11])
    for idx, t in ((0, 6), (index, T)):
        k = rng.normal(size=(B, t, H, head_dim)).astype(np.float32)
        v = rng.normal(size=(B, t, H, head_dim)).astype(np.float32) * 2
        jcache = jkv.append_kv_stacked(jcache, jnp.asarray(k),
                                       jnp.asarray(v), layer,
                                       jnp.asarray(idx))
        pv = torch.from_numpy(np.broadcast_to(np.int32(idx), (B,)).copy())
        extra = (pv,) if pos_vec else ()
        tkv.append_kv_stacked(tcache, torch.from_numpy(k),
                              torch.from_numpy(v), layer,
                              torch.from_numpy(np.asarray(idx)) if t == T
                              else idx, *extra)
    want = from_jax_kv([np.asarray(a) for a in jcache], head_dim, "cpu")
    for g, w in zip(tcache, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_append_past_the_end_raises():
    cache = tkv.init_kv(1, 1, 4, 1, 8, torch.device("cpu"))
    x = torch.zeros(1, 3, 1, 8)
    with pytest.raises(ValueError):
        tkv.append_kv_stacked(cache, x, x, 0, 2)
    # per sequence: one sequence past the end is enough
    cache = tkv.init_kv(1, 2, 4, 1, 8, torch.device("cpu"))
    x = torch.zeros(2, 2, 1, 8)
    with pytest.raises(ValueError):
        tkv.append_kv_stacked(cache, x, x, 0, torch.tensor([0, 3]))


class _Entry:
    """A stand-in C entry point: records its arguments, returns 0."""

    argtypes = None

    def __init__(self, calls):
        self.calls = calls

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """The CUDA branch on CPU tensors: tensors report ``is_cuda`` and the
    kernel's library is a stand-in that records each call."""
    calls = []
    lib = type("Lib", (), {})()
    lib.kv_append = _Entry(calls)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(tkv._ext, "load", lambda src: lib)
    monkeypatch.setattr(tkv._ext, "stream_ptr", lambda dev: 0)
    return calls


@pytest.mark.parametrize("cache_dtype,kind", [(torch.int8, 0),
                                              (torch.bfloat16, 1),
                                              (torch.float32, 2)])
def test_card_path_is_one_launch_on_the_layer(stand_in, cache_dtype, kind):
    """A fused qkv's split views go to the kernel as they are (their
    pointers and strides, no copy), with the layer's own memory, the
    device positions and the shapes: one launch, one ``kv.copies``, no
    plain call; a shared int index makes its positions on the device."""
    from ant_quantization_tpu_torch.utils import profiling
    L, B, T, H, S, D = 2, 3, 5, 2, 16, 96
    cache = tkv.init_kv(L, B, S, H, D, torch.device("cpu"), cache_dtype)
    qkv = torch.randn(B * T, 3 * H * D).to(torch.bfloat16)
    _, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    pos_vec = torch.tensor([0, 7, S - T], dtype=torch.int32)
    before = dict(tkv.COUNTS)
    profiling.clear()
    with profiling.recording():
        tkv.append_kv_stacked(cache, k, v, 1, [0, 7, S - T], pos_vec)
        tkv.append_kv_stacked(cache, k, v, 0, 4)
    args, shared = stand_in
    assert args[:3] == (k.data_ptr(), v.data_ptr(), 1)
    assert args[1] - args[0] == H * D * 2          # views of qkv
    assert args[3:11] == (*k.stride(), *v.stride())
    assert args[3:7] == (T * 3 * H * D, 3 * H * D, D, 1)
    assert args[11:13] == (cache.k[1].data_ptr(), cache.v[1].data_ptr())
    assert args[13:15] == ((cache.k_scale[1].data_ptr(),
                            cache.v_scale[1].data_ptr()) if kind == 0
                           else (0, 0))
    assert args[15:17] == (kind, pos_vec.data_ptr())
    assert args[17:22] == (B, T, H, S, D)
    assert shared[11] == cache.k[0].data_ptr()
    assert tkv.COUNTS == {"launches": before["launches"] + 2,
                          "plain_calls": before["plain_calls"]}
    recs = profiling.records()
    assert [r[0] for r in recs] == ["kv.append"] * 2   # no child span
    assert [(n, c) for n, c, _, _ in profiling.counts()] == [
        ("kv.copies", 1), ("kv.copies", 1)]


def test_card_path_refuses_before_any_launch(stand_in):
    """A write past the end, per sequence or shared, raises on the host
    before the kernel is called; so does a head_dim past 256."""
    cache = tkv.init_kv(1, 2, 8, 1, 16, torch.device("cpu"))
    x = torch.zeros(2, 3, 1, 16)
    pv = torch.tensor([0, 6], dtype=torch.int32)
    with pytest.raises(ValueError):
        tkv.append_kv_stacked(cache, x, x, 0, [0, 6], pv)
    with pytest.raises(ValueError):
        tkv.append_kv_stacked(cache, x, x, 0, 6)
    wide = tkv.init_kv(1, 2, 8, 1, 257, torch.device("cpu"))
    with pytest.raises(NotImplementedError):
        tkv.append_kv_stacked(wide, *(torch.zeros(2, 1, 1, 257),) * 2, 0, 0)
    assert stand_in == []


@pytest.mark.parametrize("family", ["opt", "bloom"])
def test_engine_passes_pos_vec_positionally(monkeypatch, family):
    """Each layer's append gets the forward's device positions as its
    sixth positional argument and no keyword: a stand-in that takes
    ``(cache, *a)`` (the benchmark's no-KV fault) replaces it whole."""
    cfg, ep = tiny_engine(family)
    seen = []

    def record(cache, *a, **kw):
        seen.append((a, kw))
        return cache

    monkeypatch.setattr(eng, "append_kv_stacked", record)
    kv = eng.init_cache(cfg, 2, "cpu")
    pos = torch.tensor([3, 9], dtype=torch.int32)
    eng.forward(cfg, ep, torch.ones((2, 1), dtype=torch.long), kv, pos)
    assert len(seen) == cfg.lm.n_layers
    for layer, (a, kw) in enumerate(seen):
        assert kw == {} and len(a) == 5 and a[2] == layer
        assert a[3] == [3, 9] and torch.equal(a[4], pos)


# ---- on the card ----------------------------------------------------------

_L, _B, _H, _S = 2, 3, 2, 300


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run there")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as integers (so -0.0 and 0.0 differ)."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _canary_cache(card, D: int, dtype, seed: int) -> tkv.QuantKV:
    """A cache filled with random bytes: what the append does not write
    must come back unchanged."""
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    raw = lambda shape, dt: torch.randint(
        -2 ** 7, 2 ** 7, shape + (torch.empty(0, dtype=dt).element_size(),),
        dtype=torch.int8, device=card, generator=g).view(dt)[..., 0]
    shape = (_L, _B, _H, _S)
    return tkv.QuantKV(raw(shape + (D,), dtype), raw(shape + (D,), dtype),
                       torch.rand(shape, device=card, generator=g),
                       torch.rand(shape, device=card, generator=g))


def _layouts(x: torch.Tensor, D: int):
    """(B, T, H, D) views of x's values: contiguous; split out of a fused
    qkv (row stride 3 H D); and strided along D (its stride H)."""
    B, T, H, _ = x.shape
    qkv = torch.cat([torch.zeros_like(x), x, torch.zeros_like(x)],
                    dim=2).reshape(B, T, 3 * H * D)
    split = qkv.split(H * D, dim=-1)[1].reshape(B, T, H, D)
    strided = x.transpose(2, 3).contiguous().transpose(2, 3)
    assert split.data_ptr() != x.data_ptr() and not split.is_contiguous()
    assert strided.stride(-1) == H
    return {"contiguous": x.contiguous(), "split": split,
            "strided": strided}


def _kv_inputs(card, B, T, H, D, dtype, seed: int):
    """New k and v: normal rows of several sizes, one all-zero row of k
    (scale 1.0) and one row of v whose divisions land on exact halves
    (round half to even: amax 127 * 2^-3 makes the scale 2^-3)."""
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    k = torch.randn((B, T, H, D), device=card, generator=g) * 3
    v = torch.randn((B, T, H, D), device=card, generator=g) * torch.rand(
        (B, T, H, 1), device=card, generator=g) * 8
    k[min(1, B - 1), 0, H - 1] = 0.0
    halves = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5, 125.5],
                          device=card)
    row = halves.repeat(-(-D // 8))[:D].clone()
    row[0] = 127.0
    v[0, T - 1, 0] = row * 0.125
    return k.to(dtype), v.to(dtype)


def _check_against_plain(card, cache, k, v, layer, index, pos_vec):
    """The kernel's cache against the plain version's on the CPU (the
    path the tests hold to the reference), bit for bit, every byte."""
    want = tkv.QuantKV(*(a.cpu() for a in cache))
    tkv.append_kv_stacked_plain(want, k.cpu(), v.cpu(), layer, index)
    before = tkv.COUNTS["launches"]
    tkv.append_kv_stacked(cache, k, v, layer, index, *(
        () if pos_vec is None else (pos_vec,)))
    assert tkv.COUNTS["launches"] == before + 1
    torch.cuda.synchronize()
    for name, g, w in zip(tkv.QuantKV._fields, cache, want):
        assert torch.equal(_bits(g.cpu()), _bits(w)), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [1, 5, 17, 256])
@pytest.mark.parametrize("D", [16, 64, 80, 96, 128, 256])
def test_kernel_matches_plain(card, D, T, dtype):
    """The INT8 cache: per-sequence ragged positions (the last sequence
    ends at the last row, pos + T = S) with the device positions given,
    and a shared int index without them, over each layout of the new
    k and v."""
    k, v = _kv_inputs(card, _B, T, _H, D, dtype, seed=D * 1000 + T)
    starts = [0, min(37, _S - T), _S - T]
    for i, (name, kx) in enumerate(_layouts(k, D).items()):
        vx = _layouts(v, D)[name]
        cache = _canary_cache(card, D, torch.int8, seed=i)
        pv = torch.tensor(starts, dtype=torch.int32, device=card)
        _check_against_plain(card, cache, kx, vx, 1, starts, pv)
        _check_against_plain(card, cache, kx, vx, 0, _S - T - i, None)


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [1, 17])
@pytest.mark.parametrize("D", [16, 80, 128, 256])
def test_raw_cache_kernel_matches_plain(card, D, T, cache_dtype):
    """The raw (bf16 or f32) cache: the values cast as the plain version
    casts them, from bf16 and f32 inputs, split views and strided."""
    starts = [_S - T, 3, 0]
    for dtype in (torch.bfloat16, torch.float32):
        k, v = _kv_inputs(card, _B, T, _H, D, dtype, seed=D + T)
        for i, (name, kx) in enumerate(_layouts(k, D).items()):
            cache = _canary_cache(card, D, cache_dtype, seed=10 + i)
            _check_against_plain(card, cache, kx, _layouts(v, D)[name], 1,
                                 starts, None)


@pytest.mark.cuda
def test_kernel_refuses_a_write_past_the_end(card):
    """A write past the end raises on the host before any launch, and
    the cache is untouched."""
    cache = _canary_cache(card, 64, torch.int8, seed=3)
    before = [a.clone() for a in cache]
    x = torch.randn((_B, 2, _H, 64), device=card)
    pv = torch.tensor([0, 5, _S - 1], dtype=torch.int32, device=card)
    n = tkv.COUNTS["launches"]
    with pytest.raises(ValueError):
        tkv.append_kv_stacked(cache, x, x, 1, [0, 5, _S - 1], pv)
    with pytest.raises(ValueError):
        tkv.append_kv_stacked(cache, x, x, 1, _S - 1)
    torch.cuda.synchronize()
    assert tkv.COUNTS["launches"] == n
    assert all(torch.equal(a, b) for a, b in zip(cache, before))

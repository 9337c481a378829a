"""PyTorch port vs the JAX reference: K2 and K7 at head_dim 64 (GPT-2,
OPT-125m and -1.3b, BLOOM-560m), 80 (BLOOM-3b), 96 (BLOOM-1b1), 16 (the
reference's flagship LM), 256 (the widest the CUDA kernels serve) and
40 (no multiple of 16), beside the 128 of the other attention tests.

- K2's plain version (the CPU path of
  kernels/attention.py:stacked_int8_kv_attention) against the reference's
  Pallas kernel in interpret mode: at head_dim 64 the reference reads its
  lane-folded cache (two positions to a 128-lane row, scales plane-major),
  which ``convert.from_jax_kv`` unfolds into the port's flat cache by
  position; at the other head_dims both are flat. Decode (T 1 and 4) and
  prefill (T 40), pos0 equal and ragged, ALiBi on and off.
- K7's plain version against the reference's ``int8_kv_attention`` (a
  flat layer) at every head_dim, T 1 and 16, and at T 17 and 64 (more
  queries than the reference's engine sends it; the port's card path
  takes K2's prefill kernel there).
- The three-bf16-term emulation of K2's prefill regime
  (``stacked_int8_kv_attention_hilo``, at the kernels' width: zeros past
  D) within K2's f32 tolerance of the plain version at every head_dim.
- ``attention_route`` equal to the route the reference's
  ``_attention_stacked`` takes at GPT-2 XL's, BLOOM-3b's and BLOOM-1b1's
  head_dims, across the reference's 6 MiB tile rule.
- ``KERNEL_WIDTHS`` equal to the widths ``csrc/kv_split.cuh`` builds.

Tolerances as in ``test_torch_attention_flat.py``: atol 1e-4 at f32
output, atol 2e-2 + rtol 1e-2 at bf16 output (``K2_TOL`` of
chip_smoke.py)."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.kernels.attention import int8_kv_attention as jk7
from ant_quantization_tpu.kernels.attention import (
    stacked_int8_kv_attention as jk2)
from ant_quantization_tpu.models.transformer_lm import LMConfig as JLMConfig
from ant_quantization_tpu.serve import engine as jeng
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.kernels import attention as tk
from ant_quantization_tpu_torch.models.transformer_lm import (bloom_config,
                                                              gpt2_config)
from ant_quantization_tpu_torch.serve import engine as teng

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

_L, _B, _H, _S = 2, 2, 2, 64
_SLOPES = np.float32([0.5, 0.0625])
_TOL = {"f32": (1e-4, 0.0), "bf16": (2e-2, 1e-2)}
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cache(D, seed, S=_S):
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (_L, _B, _H, S, D)).astype(np.int8)
    v = rng.integers(-127, 128, (_L, _B, _H, S, D)).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, (_L, _B, _H, S)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, (_L, _B, _H, S)).astype(np.float32)
    return k, v, ks, vs


def _fold(k, v, ks, vs, D):
    """The reference's layout of a flat cache (kernels/kv_cache.py): f =
    128 / D positions to a row (position p at row p // f, lanes
    [(p % f) D, (p % f + 1) D)), f = 1 at head_dims that do not divide
    128 and outside 32 .. 64 (``kv_fold``); scales plane-major (p at
    [p % f, p // f]) at every f."""
    f = 128 // D if 32 <= D < 128 and 128 % D == 0 else 1
    L, B, H, S = ks.shape
    codes = lambda a: a.reshape(L, B, H, S // f, f * D)
    scales = lambda a: np.ascontiguousarray(
        a.reshape(L, B, H, S // f, f).swapaxes(-1, -2))
    return (codes(k), codes(v), scales(ks), scales(vs)), f


def _pos0(kind, T, S=_S):
    return np.int32([0, 0] if kind == "zero" else [3, S - T])


_K2_CASES = [(1, "ragged", True, "f32"), (4, "zero", False, "bf16"),
             (40, "ragged", False, "f32"), (40, "zero", True, "bf16")]


_DS = [64, 80, 96, 16, 256, 40]


@pytest.mark.parametrize("D", _DS)
@pytest.mark.parametrize("T,p0,alibi,out", _K2_CASES)
def test_k2_plain_matches_pallas(D, T, p0, alibi, out):
    k, v, ks, vs = _cache(D, seed=D + T)
    (jk_, jv_, jks, jvs), f = _fold(k, v, ks, vs, D)
    assert f == (2 if D == 64 else 1)
    q = np.random.default_rng(T).normal(size=(_B, _H, T, D)).astype(
        np.float32)
    pos0 = _pos0(p0, T)
    slopes = _SLOPES if alibi else None
    jdt, tdt = _DT[out]
    want = np.asarray(jk2(
        jnp.int32(1), jnp.asarray(q), jnp.asarray(jk_), jnp.asarray(jv_),
        jnp.asarray(jks), jnp.asarray(jvs), jnp.asarray(pos0),
        None if slopes is None else jnp.asarray(slopes), out_dtype=jdt,
        interpret=True).astype(jnp.float32))
    # the port's flat cache, unfolded from the reference's by position
    cache = convert.from_jax_kv((jk_, jv_, jks, jvs), D, device="cpu")
    for got_a, flat in zip(cache, (k, v, ks, vs)):
        np.testing.assert_array_equal(got_a.numpy(), flat)
    t = torch.from_numpy
    before = dict(tk.COUNTS)
    got = tk.stacked_int8_kv_attention(
        1, t(q), *cache, t(pos0), None if slopes is None else t(slopes),
        out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (_B, _H, T, D)
    atol, rtol = _TOL[out]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)
    assert tk.COUNTS["plain_calls"] == before["plain_calls"] + 1
    assert tk.COUNTS["launches"] == before["launches"]


@pytest.mark.parametrize("D", _DS)
@pytest.mark.parametrize("T,alibi,out", [(1, True, "f32"),
                                         (16, False, "bf16"),
                                         (17, True, "bf16"),
                                         (64, False, "f32")])
def test_k7_plain_matches_pallas(D, T, alibi, out):
    k, v, ks, vs = (a[0] for a in _cache(D, seed=3 * D + T))
    q = np.random.default_rng(5).normal(size=(_B, _H, T, D)).astype(
        np.float32)
    pos0 = np.int32([0, min(23, _S - T)])
    slopes = _SLOPES if alibi else None
    jdt, tdt = _DT[out]
    want = np.asarray(jk7(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(pos0),
        None if slopes is None else jnp.asarray(slopes), out_dtype=jdt,
        interpret=True).astype(jnp.float32))
    t = torch.from_numpy
    before = dict(tk.K7_COUNTS)
    got = tk.int8_kv_attention(t(q), t(k), t(v), t(ks), t(vs), t(pos0),
                               None if slopes is None else t(slopes),
                               out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (_B, _H, T, D)
    atol, rtol = _TOL[out]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)
    assert tk.K7_COUNTS["plain_calls"] == before["plain_calls"] + 1
    assert tk.K7_COUNTS["launches"] == before["launches"]


@pytest.mark.parametrize("D", _DS)
@pytest.mark.parametrize("adversarial", [False, True])
def test_k2_hilo_within_tolerance(D, adversarial):
    """K2's prefill arithmetic (three bf16 terms per f32 operand, online
    softmax over tiles of 64) at the kernels' width W >= D (W / 16
    k-steps, W / 8 n-tiles, zeros past D), within atol 1e-4 of the plain
    version; the adversarial case takes q x 8 and scales spread over
    1e-4 .. 1e-1, as test_torch_attention_hilo.py."""
    S, T = 130, 40
    rng = np.random.default_rng(D)
    k, v, ks, vs = _cache(D, seed=D, S=S)
    q = rng.normal(size=(_B, _H, T, D)).astype(np.float32)
    if adversarial:
        q *= 8
        ks = (10.0 ** rng.uniform(-4, -1, ks.shape)).astype(np.float32)
        vs = (10.0 ** rng.uniform(-4, -1, vs.shape)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, k, v, ks, vs)]
    pos0 = torch.from_numpy(_pos0("ragged", T, S))
    slopes = torch.from_numpy(_SLOPES)
    want = tk.stacked_int8_kv_attention_plain(1, *args, pos0, slopes,
                                              out_dtype=torch.float32)
    got = tk.stacked_int8_kv_attention_hilo(1, *args, pos0, slopes)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=_TOL["f32"][0])


def _reference_route(monkeypatch, head_dim, T, S):
    """The route the reference's ``_attention_stacked`` takes for T
    queries against its INT8 cache of max_seq S: its stacked kernel
    ("K2"), the flat per-layer kernel ("K7") or the einsum. One head of
    ``head_dim`` (the rule is per head)."""
    lm = JLMConfig(vocab_size=8, d_model=head_dim, n_layers=1, n_heads=1,
                   d_ff=8, max_seq=S, positions="learned",
                   activation="gelu_new", fused_qkv=True)
    cfg = jeng.EngineConfig(lm=lm, weight_mode="w4", kv_int8=True,
                            max_seq=S, dtype=jnp.float32, interpret=True)
    seen = []
    monkeypatch.setattr(jeng, "_kernel_attention_chunked",
                        lambda cfg_, l, qh, *a: seen.append("K2") or qh)
    monkeypatch.setattr(jeng, "int8_kv_attention",
                        lambda q, *a, **kw: seen.append("K7") or q)
    q = jnp.zeros((1, T, 1, head_dim), jnp.float32)
    jeng._attention_stacked(cfg, q, jeng.init_cache(cfg, 1), 0,
                            jnp.zeros((1,), jnp.int32), T, None)
    return seen[0] if seen else "einsum"


# (T, S) across each head_dim's tile rule: head_dim 64 (folded) keeps K2
# up to S = 21,830 for 8 or more queries, then the einsum; head_dim 80
# (flat) up to 17,858, then K7 for T <= 16; head_dim 96 (flat) up to
# 15,108 (16,213 for one query)
_ROUTE_CASES = {
    "gpt2-xl": [(1, 1024), (512, 1024), (8, 21830), (8, 21832),
                (1, 21833), (16, 24001)],
    "bloom-3b": [(1, 2048), (512, 2048), (8, 17858), (8, 17859),
                 (16, 17859), (17, 17859), (1, 19417)],
    "bloom-1b1": [(1, 2048), (512, 2048), (8, 15108), (8, 15109),
                  (16, 15109), (17, 15109), (1, 16213), (1, 16214)],
}
_ROUTE_MODELS = {
    "gpt2-xl": gpt2_config("xl"), "bloom-3b": bloom_config("3b"),
    # Hugging Face bigscience/bloom-1b1: hidden 1536, 16 heads of 96
    "bloom-1b1": dataclasses.replace(bloom_config("7b1"), d_model=1536,
                                     n_heads=16, d_ff=6144, n_layers=24)}


@pytest.mark.parametrize("model", list(_ROUTE_CASES))
def test_attention_route_matches_reference(monkeypatch, model):
    c = _ROUTE_MODELS[model]
    routes = []
    for T, S in _ROUTE_CASES[model]:
        want = _reference_route(monkeypatch, c.head_dim, T, S)
        assert teng.attention_route(c, T, S) == want, (model, T, S)
        routes.append(want)
    assert set(routes) == ({"K2", "einsum"} if model == "gpt2-xl"
                           else {"K2", "K7", "einsum"})


def test_kernel_widths_match_the_cuda_header():
    """``KERNEL_WIDTHS`` lists the widths ``KV_WIDTHS`` in
    ``csrc/kv_split.cuh`` builds, and every head_dim from 1 to 256 runs
    at the smallest of them at or above it."""
    header = (Path(tk.__file__).resolve().parent.parent / "csrc"
              / "kv_split.cuh").read_text()
    line = re.search(r"#define KV_WIDTHS\(X\)(.*)", header).group(1)
    widths = tuple(int(w) for w in re.findall(r"X\((\d+)\)", line))
    assert widths == tk.KERNEL_WIDTHS
    assert tk.MAX_HEAD_DIM == widths[-1] == 256
    for D in range(1, tk.MAX_HEAD_DIM + 1):
        w = tk.kernel_width(D)
        assert w >= D and w % 16 == 0
        assert not any(D <= x < w for x in widths)


class _Entry:
    """A stand-in C entry point: records its arguments, returns 0."""

    def __init__(self, name, calls):
        self.name, self.calls, self.argtypes = name, calls, None

    def __call__(self, *args):
        assert len(args) == len(self.argtypes)
        self.calls.append((self.name, args))
        return 0


@pytest.mark.parametrize("D", [96, 40])
def test_card_path_launches_once_on_the_layer(monkeypatch, D):
    """The CUDA branch of both wrappers (tensors that report ``is_cuda``,
    stand-in libraries that record each call): one entry point a call on
    the layer's own memory, the split pass up to 16 queries and the
    prefill kernel above, with the true head_dim and its qscale, counted
    in the wrapper's counts."""
    calls = []
    libs = {src: type("Lib", (), {})() for src in (tk._SOURCE,
                                                   tk._SPLIT_SOURCE)}
    libs[tk._SOURCE].int8_kv_attention_prefill = _Entry("prefill", calls)
    libs[tk._SPLIT_SOURCE].int8_kv_attention_split = _Entry("split", calls)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(tk._ext, "load", lambda src: libs[src])
    monkeypatch.setattr(tk._ext, "stream_ptr", lambda dev: 0)
    k, v, ks, vs = (torch.from_numpy(a) for a in _cache(D, seed=1))
    pos0 = torch.zeros((_B,), dtype=torch.int32)
    qscale = float(np.float32(1 / np.sqrt(D)))
    for T, want in ((1, "split"), (16, "split"), (17, "prefill"),
                    (64, "prefill")):
        q = torch.zeros((_B, _H, T, D))
        for l, counts, call in (
                (1, tk.COUNTS, lambda: tk.stacked_int8_kv_attention(
                    1, q, k, v, ks, vs, pos0)),
                (0, tk.K7_COUNTS, lambda: tk.int8_kv_attention(
                    q, k[0], v[0], ks[0], vs[0], pos0))):
            before = dict(counts)
            out = call()
            assert out.shape == (_B, _H, T, D)
            name, args = calls.pop()
            assert name == want and not calls
            assert args[2:6] == (k[l].data_ptr(), v[l].data_ptr(),
                                 ks[l].data_ptr(), vs[l].data_ptr())
            ints = args[-8:-2] if want == "split" else args[-7:-2]
            assert ints[:5] == (_B, _H, T, _S, D)
            assert args[-2] == qscale
            assert counts == {"launches": before["launches"] + 1,
                              "plain_calls": before["plain_calls"]}

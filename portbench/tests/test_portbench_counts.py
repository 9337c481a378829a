"""The yardstick's byte and operation counts against sizes worked out by
hand from the published widths."""

from __future__ import annotations

import pytest

from portbench import counts, spec


def _lm(name: str) -> dict:
    return spec.load_json(spec.PKG / "configs" / f"{name}.json")["lm"]


OPT, BLOOM = _lm("opt-6.7b-ant-w4a4"), _lm("bloom-7b1-ant-w4a4")


def test_opt_6_7b_codes():
    # 32 layers of q, k, v, out (4096 x 4096) and fc_in, fc_out
    # (4096 x 16384): 32 x 201,326,592
    assert counts.layer_code_bytes(OPT) == 6_442_450_944
    assert counts.head_code_bytes(OPT) == 50272 * 4096 == 205_914_112


def test_bloom_7b1_codes():
    # 30 layers of a fused qkv (4096 x 12288), out and the MLP
    assert counts.layer_code_bytes(BLOOM) == 30 * 201_326_592 == 6_039_797_760
    assert counts.head_code_bytes(BLOOM) == 250880 * 4096 == 1_027_604_480


@pytest.mark.parametrize("lm", (OPT, BLOOM))
def test_kv_per_position_layer_and_slot(lm):
    # 32 heads x (128 key + 128 value codes + two f32 scales)
    assert counts.kv_bytes_per_position(lm) == 8448


def test_kv_cache_sizes():
    # slots x max_seq x layers x 8,448 B: OPT at 64 slots, BLOOM at 32
    per = counts.kv_bytes_per_position
    assert 64 * 2048 * 32 * per(OPT) == 35_433_480_192
    assert 32 * 2048 * 30 * per(BLOOM) == 16_609_443_840


def test_k1_launch_and_forward():
    byts, ops = counts.k1_launch(64, 4096, 16384)
    assert byts == 4096 * 16384 + 4 * 64 * 4096 + 4 * 64 * 16384 \
        + 4 * 16384 + 64 + 4
    assert ops == 2 * 64 * 4096 * 16384
    n, b, o = counts.k1_forward(OPT, 32)
    assert n == 32 * 6
    assert o == 2 * 32 * counts.layer_code_bytes(OPT)


def test_k2_decode_counts_served_positions():
    # two sequences writing at positions 9 and 99 attend 10 and 100
    byts, ops = counts.k2_decode_layer(OPT, [9, 99])
    assert byts == 110 * 32 * 264 + 2 * 32 * 128 * 4 + 8 + 128
    assert ops == 110 * 32 * 4 * 128
    assert counts.k2_decode_layer(OPT, []) == (4 * 32, 0)


def test_forward_bounds():
    # a decode tick of 32 sequences is bound by its bytes: codes, head,
    # the KV they attend and their bf16 q and output, over 3.35 TB/s
    pos = [1000] * 32
    kv = 32 * 1001 * 32 * 264 * 32
    qo = 32 * 32 * 128 * 4 * 32
    want = (6_442_450_944 + 205_914_112 + kv + qo) / 3.35e12
    assert counts.decode_forward_s(OPT, pos) == pytest.approx(want, rel=1e-5)
    # a prefill of 1536 tokens is bound by its int8 operations
    t = counts.prefill_forward_s(OPT, 1536)
    assert t == pytest.approx(2 * 1536 * 6_442_450_944 / 1.979e15
                              + 2 * 205_914_112 / 1.979e15
                              + 32 * 32 * 4 * 128 * 1536 * 1537 / 2 / 989e12,
                              rel=1e-6)
    assert counts.decode_forward_s(OPT, []) == 0.0

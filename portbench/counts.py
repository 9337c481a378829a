"""The yardstick's arithmetic: the H100's peaks and the operations and
bytes of the work a forward does, counted from the configuration's
shapes, so that they hold whatever kernel does the work.

Copied from the port's measurement code (``chip_smoke.py``: ``_bound``,
``k1_bound``, ``k2_bound``, ``stream_floor``; ``lm_bench.py``:
``matmul_flops``, ``PEAK_INT8``), restated on the configuration's
``lm`` dict. Weight codes, KV codes and head codes are one byte each; an
INT8 KV position holds a key and a value of ``head_dim`` codes and two
f32 scales per head.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense, 700 W
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
BF16_FLOPS = 989e12
KV_SCALE_BYTES = 8          # an f32 scale for the key and one for the value


def head_dim(lm: dict) -> int:
    return lm["d_model"] // lm["n_heads"]


def site_shapes(lm: dict) -> Dict[str, Tuple[int, int]]:
    """(K, N) of each matmul site of one layer: a fused qkv or separate
    q, k, v."""
    d, ff = lm["d_model"], lm["d_ff"]
    qkv = {"qkv": (d, 3 * d)} if lm["fused_qkv"] else {
        s: (d, d) for s in ("q", "k", "v")}
    return {**qkv, "out": (d, d), "fc_in": (d, ff), "fc_out": (ff, d)}


def layer_params(lm: dict) -> int:
    """Weights of one layer's matmul sites (one int8 code each)."""
    return sum(K * N for K, N in site_shapes(lm).values())


def layer_code_bytes(lm: dict) -> int:
    return lm["n_layers"] * layer_params(lm)


def head_code_bytes(lm: dict) -> int:
    return lm["vocab_size"] * lm["d_model"]


def kv_bytes_per_position(lm: dict) -> int:
    """INT8 KV bytes of one position of one layer of one sequence."""
    return lm["n_heads"] * (2 * head_dim(lm) + KV_SCALE_BYTES)


def bound_s(byts: float, int8_ops: float = 0.0,
            bf16_ops: float = 0.0) -> float:
    """The least time of some work: the larger of its bytes over the HBM
    rate and its operations over the tensor-core peaks."""
    return max(byts / HBM_BPS, int8_ops / INT8_OPS + bf16_ops / BF16_FLOPS)


def k1_launch(M: int, K: int, N: int, G: int = 16) -> Tuple[int, int]:
    """(bytes, int8 operations) of one K1 launch: the weight codes, x in
    f32, the f32 output, the scales and the codebook, each once."""
    byts = K * N + 4 * M * K + 4 * M * N + 4 * N + 4 * G + 4
    return byts, 2 * M * K * N


def k1_forward(lm: dict, M: int) -> Tuple[int, int, int]:
    """(launches, bytes, operations) of K1 in one forward of M rows."""
    per = [k1_launch(M, K, N) for K, N in site_shapes(lm).values()]
    L = lm["n_layers"]
    return (L * len(per), L * sum(b for b, _ in per),
            L * sum(o for _, o in per))


def k2_decode_layer(lm: dict, positions: Iterable[int],
                    q_bytes: int = 2, out_bytes: int = 2) -> Tuple[int, int]:
    """(bytes, bf16 operations) of one layer's decode attention (one
    query a sequence) for the sequences writing at ``positions``: each
    attends its positions 0..p, read once, q read and the output written
    once."""
    pos = list(positions)
    H, D = lm["n_heads"], head_dim(lm)
    keys = sum(p + 1 for p in pos)
    byts = (keys * H * (2 * D + KV_SCALE_BYTES)
            + len(pos) * H * D * (q_bytes + out_bytes) + 4 * len(pos) + 4 * H)
    return byts, keys * H * 4 * D


def decode_forward_s(lm: dict, positions: Iterable[int]) -> float:
    """The least time of one decode tick for the sequences writing at
    ``positions``: the weights, the head and the KV they attend, each
    read once, against their int8 products and attention."""
    pos = list(positions)
    n, L = len(pos), lm["n_layers"]
    if n == 0:
        return 0.0
    kv_b, attn_ops = k2_decode_layer(lm, pos)
    byts = layer_code_bytes(lm) + head_code_bytes(lm) + L * kv_b
    int8_ops = 2 * n * (layer_code_bytes(lm) + head_code_bytes(lm))
    return bound_s(byts, int8_ops, L * attn_ops)


def prefill_forward_s(lm: dict, T: int) -> float:
    """The least time of a serving prefill of T real prompt tokens (the
    head on the last position only)."""
    L, H, D = lm["n_layers"], lm["n_heads"], head_dim(lm)
    byts = (layer_code_bytes(lm) + head_code_bytes(lm)
            + L * T * kv_bytes_per_position(lm))
    int8_ops = 2 * T * layer_code_bytes(lm) + 2 * head_code_bytes(lm)
    attn_ops = L * H * 4 * D * T * (T + 1) // 2
    return bound_s(byts, int8_ops, attn_ops)

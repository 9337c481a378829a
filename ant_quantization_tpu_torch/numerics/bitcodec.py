"""Bit-level storage codecs: flint codewords and OVP pair packing.

Counterpart of the reference's ``numerics/bitcodec.py``:

- **flint** (ANT's adaptive type): B-bit codewords with a unary exponent
  prefix (e < 0 as |e| zeros then a one, e >= 0 as e + 1 ones then a
  zero) and the mantissa in the remaining bits, so every codeword is
  self-delimiting; signed formats spend the top bit on sign. The tables
  are host data.
- **OVP** (OliVe): two 4-bit codes per aligned byte; an outlier spends
  its victim's nibble, and a little-endian sideband of 2 bits per pair
  (00 normal, 10 even-slot outlier, 11 odd-slot outlier) marks the
  outlier pairs.
- the engine checkpoint codec: a stacked "w4" weight store (int8
  codebook values or sign-offset OVP bytes) at true 4-bit density,
  per-layer 16-entry value tables and two codes per byte.

The pair codec and the stack codec are torch ops on the tensors' own
device (a layer of OPT-6.7B's fc stacks holds 67M codes): per-layer
value tables from a 256-entry presence table of the int8 values (the
sorted unique values, so a value's code is its rank, the reference's
``np.unique`` + ``searchsorted``), nibble shifts and a hand-written
little-endian ``packbits``. The arrays they store are bit-equal to the
reference's for the same logical (L, K, N) stack.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

__all__ = ["flint_codewords", "flint_decode_table", "ovp_pack",
           "ovp_unpack", "pack_w4_stack", "unpack_w4_stack", "packbits",
           "unpackbits", "W4_KEYS"]

# the leaves pack_w4_stack stores in place of a site's w_i8
W4_KEYS = ("w4_packed", "w4_side", "w4_ntab", "w4_otab", "w4_shape")


# ---------------------------------------------------------------------------
# flint codewords
# ---------------------------------------------------------------------------

def _flint_entries(value_bit: int) -> List[Tuple[int, int, int]]:
    """(exp, mant_bits, mant) for every magnitude of a flint format with
    ``value_bit`` bits after the sign (generator loop order)."""
    out = []
    neg = value_bit - 1
    pos = value_bit - 1
    for i in range(0, neg + 1):                    # e = -(i+1)
        exp_bits = i + 2
        e = -(i + 1)
        mant_bits = value_bit - exp_bits
        for m in range(int(2 ** mant_bits)):       # <0 mant bits: empty
            out.append((e, mant_bits, m))
    exp_bits = 2                                   # e = 0
    mant_bits = value_bit - exp_bits
    for m in range(2 ** mant_bits):
        out.append((0, mant_bits, m))
    for e in range(1, pos):                        # e > 0
        exp_bits = e + 2
        mant_bits = value_bit - exp_bits
        for m in range(2 ** mant_bits):
            out.append((e, mant_bits, m))
    out.append((pos, 0, 0))                        # endpoint 2^pos
    return out


def _exp_prefix(e: int, e_max: int) -> str:
    """Unary exponent prefix: e<0 -> |e| zeros + '1'; e>=0 -> (e+1) ones
    then a terminating '0' unless the run already fills the budget
    (e = e_max, the endpoint, needs no terminator)."""
    if e < 0:
        return "0" * (-e) + "1"
    ones = "1" * (e + 1)
    return ones if e + 1 >= e_max + 1 else ones + "0"


def flint_codewords(bit: int, signed: bool = True) -> Dict[str, float]:
    """codeword-bitstring -> value for a ``bit``-wide flint format.

    Every codeword is exactly ``bit`` bits (sign + exponent prefix +
    mantissa); the mapping is a bijection onto the flint grid magnitudes
    (plus 0, encoded as all-zeros with a sign bit of 0)."""
    value_bit = bit - 1 if signed else bit
    e_max = value_bit - 1
    table: Dict[str, float] = {}

    def put(sign_bit: str, body: str, value: float):
        word = sign_bit + body if signed else body
        if len(word) != bit or word in table:
            raise ValueError(f"flint codeword {word!r} of {bit} bits")
        table[word] = value

    put("0" if signed else "", "0" * value_bit, 0.0)
    for e, mant_bits, m in _flint_entries(value_bit):
        prefix = _exp_prefix(e, e_max)
        body = prefix + format(m, f"0{mant_bits}b") if mant_bits else prefix
        # the all-zeros body is reserved for 0: the e=-(value_bit-1)
        # prefix "0..01" never collides with it
        mag = (2.0 ** e) * (1 + m * 2.0 ** -mant_bits) if mant_bits \
            else 2.0 ** e
        if signed:
            put("0", body, mag)
            put("1", body, -mag)
        else:
            put("", body, mag)
    return table


def flint_decode_table(bit: int, signed: bool = True) -> torch.Tensor:
    """(2^bit,) f64 decode table on the host: the value of each codeword
    read as an integer (missing codewords, if any, decode to 0)."""
    lut = torch.zeros(2 ** bit, dtype=torch.float64)
    for word, value in flint_codewords(bit, signed).items():
        lut[int(word, 2)] = value
    return lut


# ---------------------------------------------------------------------------
# OVP pair packing
# ---------------------------------------------------------------------------

def packbits(bits: torch.Tensor) -> torch.Tensor:
    """numpy's ``packbits(bitorder="little")`` of a flat 0/1 tensor: bit j
    of byte i is element 8 i + j, the tail padded with zeros."""
    n = bits.shape[0]
    b = torch.zeros(-(-n // 8) * 8, dtype=torch.uint8, device=bits.device)
    b[:n] = bits.to(torch.uint8)
    b = b.view(-1, 8)
    out = b[:, 0].clone()
    for j in range(1, 8):
        out |= b[:, j] << j
    return out


def unpackbits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` bits of little-endian bytes, as a flat uint8 0/1
    tensor (numpy's ``unpackbits(bitorder="little")[:n]``)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts) & 1).reshape(-1)[:n]


def ovp_pack(normal_codes: torch.Tensor, outlier_codes: torch.Tensor,
             outlier_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack per-element 4-bit codes into aligned pair bytes.

    normal_codes:  (N,) uint8 in [0,16), an index into the normal grid
    outlier_codes: (N,) uint8 in [0,16), an index into the abfloat grid
                   (only read where outlier_mask)
    outlier_mask:  (N,) bool, at most one True per aligned pair (the OVP
                   guarantee: the partner is the zeroed victim)

    Returns (packed (N//2,) uint8, sideband (ceil(N/8),) uint8): a normal
    pair byte is [even | odd<<4]; an outlier pair byte carries the
    abfloat index in the outlier's own nibble and 0 in the victim's. The
    sideband spends 2 bits per pair, 00 normal, 10 even-slot outlier, 11
    odd-slot outlier, little-endian."""
    n = normal_codes.shape[0]
    if n % 2:
        raise ValueError(f"OVP pair packing needs an even length, got {n}")
    mask = outlier_mask.to(torch.bool)
    even_o, odd_o = mask[0::2], mask[1::2]
    if bool((even_o & odd_o).any()):
        raise ValueError("OVP: both slots of a pair are outliers")
    pair_out = even_o | odd_o
    zero = torch.zeros((), dtype=torch.uint8, device=mask.device)
    nc, oc = normal_codes.to(torch.uint8), outlier_codes.to(torch.uint8)
    lo = torch.where(even_o, oc[0::2], torch.where(odd_o, zero, nc[0::2]))
    hi = torch.where(odd_o, oc[1::2], torch.where(even_o, zero, nc[1::2]))
    side = torch.stack([pair_out, odd_o], dim=1).reshape(-1)
    return lo | (hi << 4), packbits(side)


def ovp_unpack(packed: torch.Tensor, sideband: torch.Tensor, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of :func:`ovp_pack` -> (normal_codes, outlier_codes,
    outlier_mask); victims come back as normal code 0 (their value was
    sacrificed)."""
    side = unpackbits(sideband, 2 * (n // 2)).to(torch.bool)
    pair_out = side[0::2]
    odd_o = side[1::2] & pair_out
    even_o = pair_out & ~odd_o
    lo = packed & 0xF
    hi = packed >> 4
    zero = torch.zeros((), dtype=torch.uint8, device=packed.device)
    normal = torch.stack([torch.where(pair_out, zero, lo),
                          torch.where(pair_out, zero, hi)], 1).reshape(-1)
    outlier = torch.stack([torch.where(even_o, lo, zero),
                           torch.where(odd_o, hi, zero)], 1).reshape(-1)
    mask = torch.stack([even_o, odd_o], 1).reshape(-1)
    return normal, outlier, mask


# ---------------------------------------------------------------------------
# Engine checkpoint codec: stacked w4 weight stores at true 4-bit density
# ---------------------------------------------------------------------------

def _value_table(flat: torch.Tensor, keep: torch.Tensor):
    """The sorted distinct int8 values of ``flat`` where ``keep`` (at most
    16), and each byte's rank among them: (values (n,) int8, code of
    each of the 256 byte values (256,) uint8)."""
    present = torch.zeros(256, dtype=torch.bool, device=flat.device)
    present[flat[keep].to(torch.int64) + 128] = True
    n = int(present.sum())
    if n > 16:
        raise ValueError(f"a w4 layer holds {n} distinct values (at most 16)")
    values = (torch.nonzero(present).reshape(-1) - 128).to(torch.int8)
    rank = torch.cumsum(present.to(torch.int32), 0) - present.to(torch.int32)
    return values, rank.to(torch.uint8)


def _layer_flat(w: torch.Tensor, pair_axis: int) -> torch.Tensor:
    """One layer of the port's (N, K) store flattened with the pair axis
    minor, as the reference flattens its (K, N) layer: pairs along K
    (``pair_axis`` 0) are the port's rows as they are; pairs along N
    (GPT-2's Conv1D sites) flatten (K, N)."""
    return (w if pair_axis == 0 else w.t()).contiguous().reshape(-1)


def pack_w4_stack(w_i8: torch.Tensor, ovp: bool,
                  pair_axis: int = 0) -> Dict[str, torch.Tensor]:
    """Pack a stacked "w4" weight store, the port's (L, N, K) int8
    ``w_i8`` (codebook values, or sign-offset OVP bytes), at true 4-bit
    density for engine checkpoints, on its device: ``w4_packed`` (L,
    K N / 2) uint8, ``w4_ntab`` and ``w4_otab`` (L, 16) int8 value tables,
    ``w4_shape`` [L, K, N, pair_axis] int32 (the reference's logical
    (L, K, N)) and, when any layer holds an outlier, ``w4_side`` (L,
    ceil(K N / 8)) uint8. About 0.56 times the int8 bytes.

    ``ovp`` marks sign-offset stores: bytes with |v| > 64 are abfloat
    outliers and index the second table; their zeroed victims ride as
    normal code of value 0. The OVP pair guarantee holds along
    ``pair_axis`` of (K, N), so each layer is flattened with that axis
    minor; an odd length there would let pairs straddle rows, and raises.
    """
    L, N, K = w_i8.shape
    if ovp and (K if pair_axis == 0 else N) % 2:
        raise ValueError(
            f"OVP pair packing needs an even pair-axis length; axis "
            f"{pair_axis} of (K={K}, N={N}) is odd")
    dev = w_i8.device
    packed, side, ntab, otab = [], [], [], []
    any_outlier = False
    for l in range(L):
        flat = _layer_flat(w_i8[l], pair_axis)
        mask = (flat.to(torch.int32).abs() > 64) if ovp else torch.zeros(
            flat.shape, dtype=torch.bool, device=dev)
        nv, nrank = _value_table(flat, ~mask)
        ov, orank = _value_table(flat, mask)
        idx = flat.to(torch.int64) + 128
        p, s = ovp_pack(torch.where(mask, 0, nrank[idx]), orank[idx], mask)
        packed.append(p)
        side.append(s)
        any_outlier = any_outlier or bool(mask.any())
        # the reference pads the normal table with its last entry (edge),
        # the outlier table with zeros
        nt = torch.zeros(16, dtype=torch.int8, device=dev)
        if nv.numel():
            nt[:] = nv[-1]
            nt[:nv.numel()] = nv
        ot = torch.zeros(16, dtype=torch.int8, device=dev)
        ot[:ov.numel()] = ov
        ntab.append(nt)
        otab.append(ot)
    out = {"w4_packed": torch.stack(packed), "w4_ntab": torch.stack(ntab),
           "w4_otab": torch.stack(otab),
           "w4_shape": torch.tensor([L, K, N, pair_axis], dtype=torch.int32,
                                    device=dev)}
    # outlier-free stacks (plain ANT sites) drop the sideband: 0.50x
    if any_outlier:
        out["w4_side"] = torch.stack(side)
    return out


def unpack_w4_stack(d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Inverse of :func:`pack_w4_stack` -> the exact (L, N, K) int8 store
    on the device of ``w4_packed``."""
    L, K, N, pair_axis = (int(x) for x in d["w4_shape"].tolist())
    dev = d["w4_packed"].device
    out = torch.empty((L, N, K), dtype=torch.int8, device=dev)
    for l in range(L):
        side = (d["w4_side"][l] if "w4_side" in d else
                torch.zeros(-(-K * N // 8), dtype=torch.uint8, device=dev))
        ncodes, ocodes, mask = ovp_unpack(d["w4_packed"][l], side, K * N)
        vals = d["w4_ntab"][l][ncodes.to(torch.int64)]
        if bool(mask.any()):
            vals = torch.where(mask, d["w4_otab"][l][ocodes.to(torch.int64)],
                               vals)
            # the outlier's pair partner is its zeroed victim (byte 0);
            # it came back as normal code 0, which would decode to ntab[0]
            m2 = mask.view(-1, 2)
            victim = (m2.any(dim=1, keepdim=True) & ~m2).reshape(-1)
            vals = torch.where(victim, torch.zeros_like(vals), vals)
        out[l] = (vals.view(N, K) if pair_axis == 0
                  else vals.view(K, N).t())
    return out

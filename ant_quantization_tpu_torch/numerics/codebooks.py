"""ANT and OliVe codebook (value-grid) construction, numpy only.

A copy of the reference's ``numerics/codebooks.py``: the ANT half
(``ant_grid`` and the value functions it calls) and the OliVe half
(``olive_grid`` and its normal and outlier grids). Grids depend only on
(bit, signed, mode), so they are built once on the host.

- ANT grids are normalized by ``convert_tensor``: sort ascending, pad with
  a single extra 0 if one entry short of 2^bit, then scale so max == 10.0.
- Signed grids keep duplicate zeros (the signed flint grid holds 0 twice),
  so codes index the same entries as the reference's.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ant_normalize", "int_values", "pot_values", "apot_values",
           "float_values", "flint_values", "ant_grid", "olive_int_values",
           "olive_flint_values", "olive_outlier_values", "olive_grid"]


def _value_bits(bit: int, signed: bool) -> int:
    """Magnitude bits: the sign consumes one bit when signed."""
    return bit - 1 if signed else bit


def ant_normalize(values: list[float], bit: int) -> np.ndarray:
    """Sort, pad one 0 if short, scale max to 10.0 (float32)."""
    values = list(values)
    if 2 ** bit > len(values):
        values.append(0.0)
    if 2 ** bit != len(values):
        raise ValueError(f"grid has {len(values)} entries, expected "
                         f"{2 ** bit}")
    arr = np.sort(np.asarray(values, dtype=np.float64))
    arr = arr * (10.0 / arr.max())
    return arr.astype(np.float32)


def _signed_extend(mags: list[float], signed: bool) -> list[float]:
    """Append the negation of every magnitude when signed (keeps +0/-0
    duplicates)."""
    if not signed:
        return list(mags)
    out = []
    for v in mags:
        out.append(v)
        out.append(-v)
    return out


def int_values(bit: int, signed: bool) -> list[float]:
    """Uniform integer grid; signed grids include -2^B but stop at
    2^B - 1 on the positive side."""
    b = _value_bits(bit, signed)
    values = [0.0]
    for i in range(1, 2 ** b):
        values.append(float(i))
        if signed:
            values.append(float(-i))
    if signed:
        values.append(float(-(2 ** b)))
    return values


def pot_values(bit: int, signed: bool) -> list[float]:
    """Power-of-two grid: 0 and +/-2^i for i in [0, 2^B - 1)."""
    b = _value_bits(bit, signed)
    values = [0.0]
    for i in range(0, 2 ** b - 1):
        values.append(float(2 ** i))
        if signed:
            values.append(float(-(2 ** i)))
    return values


_APOT_BASES = {
    2: ([-1, -2, -3], [], []),
    3: ([-1, -2, -4], [-3], []),
    4: ([-1, -3, -5], [-2, -4, -6], []),
    5: ([-1, -3, -6], [-2, -4, -7], [-5]),
    6: ([-1, -4, -7], [-2, -5, -8], [-3, -6, -9]),
}


def apot_values(bit: int, signed: bool) -> list[float]:
    """Additive-powers-of-two grid (value bits 2..6 only)."""
    b = _value_bits(bit, signed)
    if b not in _APOT_BASES:
        raise ValueError(f"apot undefined for value bits {b}")
    ea, eb, ec = _APOT_BASES[b]
    base_a = [0.0] + [2.0 ** e for e in ea]
    base_b = [0.0] + [2.0 ** e for e in eb]
    base_c = [0.0] + [2.0 ** e for e in ec]
    values = []
    for a in base_a:
        for bb in base_b:
            for c in base_c:
                values.append(a + bb + c)
                if signed:
                    values.append(-(a + bb + c))
    return values


def float_values(bit: int, signed: bool, exp_bit: int = 3) -> list[float]:
    """Low-bit float grid with one subnormal binade."""
    b = _value_bits(bit, signed)
    man_bit = b - exp_bit
    if b == 2:
        exp_bit, man_bit = 2, 0
    if man_bit < 0:
        raise ValueError(
            f"float grid needs value bits >= exp bits ({b} < {exp_bit})")
    values = []
    first = True
    for i in range(2 ** exp_bit):
        for j in range(2 ** man_bit):
            if first:
                values.append(0.0)
                first = False
                continue
            if i == 0:  # subnormal binade
                v = j * 2.0 ** (-man_bit)
            else:
                v = 2.0 ** (i - 1) * (1 + j * 2.0 ** (-man_bit))
            values.append(v)
            if signed:
                values.append(-v)
    return values


def _flint_magnitudes(value_bit: int, exp_base: int,
                      neg_exp_base: bool) -> list[float]:
    """Magnitudes of the flint grid: exponents -(B-1)..+(B-1) with a
    prefix-coded exponent, the top exponent only as the endpoint."""
    mags = []
    for i in range(0, value_bit):
        exp_value = -(i + 1)
        mant_bit = value_bit - (i + 2)
        if mant_bit < 0:
            continue
        e = exp_value + (exp_base if neg_exp_base else 0)
        for j in range(2 ** mant_bit):
            mags.append(2.0 ** e * (1 + j * 2.0 ** (-mant_bit)))
    mant_bit = value_bit - 2
    for j in range(2 ** mant_bit):
        mags.append(2.0 ** exp_base * (1 + j * 2.0 ** (-mant_bit)))
    for i in range(1, value_bit - 1):
        mant_bit = value_bit - (i + 2)
        for j in range(2 ** mant_bit):
            mags.append(2.0 ** (i + exp_base) * (1 + j * 2.0 ** (-mant_bit)))
    mags.append(2.0 ** (value_bit - 1 + exp_base))
    return mags


def flint_values(bit: int, signed: bool, exp_base: int = 0) -> list[float]:
    """ANT flint grid values (pre-normalization)."""
    b = _value_bits(bit, signed)
    if b < 2:
        raise ValueError("flint needs at least 2 value bits")
    mags = _flint_magnitudes(b, exp_base, neg_exp_base=True)
    return [0.0] + _signed_extend(mags, signed)


def ant_grid(mode: str, bit: int, signed: bool) -> np.ndarray:
    """A normalized (max == 10.0) ANT grid for one mode."""
    if mode == "int":
        vals = int_values(bit, signed)
    elif mode == "pot":
        vals = pot_values(bit, signed)
    elif mode == "apot":
        vals = apot_values(bit, signed)
    elif mode == "float":
        vals = float_values(bit, signed, 3)
    elif mode in ("float1", "float2", "float3", "float4"):
        vals = float_values(bit, signed, int(mode[-1]))
    elif mode == "flint":
        vals = flint_values(bit, signed)
    else:
        raise ValueError(f"unknown ANT mode {mode!r}")
    return ant_normalize(vals, bit)


# OliVe grids: normal values scaled so the outlier threshold is 32.

def olive_int_values(bit: int, signed: bool) -> np.ndarray:
    """OliVe int grid {0, +/-1 .. +/-(2^B - 1)} scaled by 32/2^B, sorted,
    unpadded. Unlike ANT's int grid there is no -2^B, so every normal
    magnitude stays below 32 and |q| > 32 marks an outlier."""
    b = _value_bits(bit, signed)
    values = [0.0] + [float(i) for i in range(1, 2 ** b)]
    if signed:
        values += [float(-i) for i in range(1, 2 ** b)]
    arr = np.sort(np.asarray(values, dtype=np.float64))
    arr = arr * (32.0 / 2 ** b)
    return arr.astype(np.float32)


def olive_flint_values(bit: int, signed: bool,
                       exp_base: int = 0) -> np.ndarray:
    """OliVe flint grid scaled by 32/2^exp_max, so its endpoint is +/-32.
    The negative-exponent loop ignores ``exp_base`` in this variant."""
    b = _value_bits(bit, signed)
    if b < 2:
        raise ValueError("flint needs at least 2 value bits")
    exp_max = (b - 1) + exp_base
    mags = _flint_magnitudes(b, exp_base, neg_exp_base=False)
    vals = [0.0] + _signed_extend(mags, signed)
    arr = np.sort(np.asarray(vals, dtype=np.float64))
    arr = arr * (32.0 / 2 ** exp_max)
    return arr.astype(np.float32)


def olive_outlier_values(bit: int, signed: bool, exp_bit: int = 2,
                         exp_base: int = 5) -> np.ndarray:
    """OliVe "abfloat" outlier grid: +/-2^i * (1 + j 2^-m) for i in
    [exp_base, exp_base + 2^exp_bit), without (exp_base, 0), which would
    collide with the normal grid's endpoint 32."""
    b = _value_bits(bit, signed)
    mant_bit = b - exp_bit
    if mant_bit < 0:
        raise ValueError(f"outlier grid needs value bits >= {exp_bit}")
    mags = []
    for i in range(exp_base, exp_base + 2 ** exp_bit):
        for j in range(2 ** mant_bit):
            if i == exp_base and j == 0:
                continue
            mags.append(2.0 ** i * (1 + j * 2.0 ** (-mant_bit)))
    vals = _signed_extend(mags, signed)
    arr = np.sort(np.asarray(vals, dtype=np.float64))
    return arr.astype(np.float32)


def olive_grid(mode: str, bit: int, signed: bool) -> np.ndarray:
    """The OliVe normal grid of one mode ("int" or "flint")."""
    if mode == "int":
        return olive_int_values(bit, signed)
    if mode == "flint":
        return olive_flint_values(bit, signed)
    raise ValueError(f"unknown OliVe mode {mode!r}")

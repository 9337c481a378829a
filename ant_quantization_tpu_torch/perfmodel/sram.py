"""SRAM energy/leakage/area model: CACTI-style power-law fits.

Counterpart of the reference's ``perfmodel/sram.py``. The reference binds
``csrc/sram_model.cc`` when ``csrc/libsram_model.so`` is built and runs
these same formulas otherwise; the two agree bit for bit, so the port
keeps the formulas alone.
"""

from __future__ import annotations

__all__ = ["sram_area_mm2", "sram_bank_model"]

# calibration anchors + exponents, as in csrc/sram_model.cc
_RD_SIZE_EXP, _WR_SIZE_EXP, _LEAK_SIZE_EXP = 0.0729, 0.2902, 0.8905
_RD_BLOCK_EXP, _WR_BLOCK_EXP = 1.3735, 1.2176
_PORT_ENERGY, _PORT_LEAK = 1.4, 1.3


def _py_read(s, b, p):
    e = 0.0168924 * (s / 4096.0) ** _RD_SIZE_EXP * (b / 64.0) ** _RD_BLOCK_EXP
    return e * _PORT_ENERGY if p else e


def _py_write(s, b, p):
    e = 0.0203422 * (s / 4096.0) ** _WR_SIZE_EXP * (b / 64.0) ** _WR_BLOCK_EXP
    return e * _PORT_ENERGY if p else e


def _py_leak(s, b, p):
    v = 2.96594 * (s / 4096.0) ** _LEAK_SIZE_EXP
    return v * _PORT_LEAK if p else v


def _py_area(s, b, p):
    a = 0.04606650594 * (s / 4096.0) ** 0.95
    return a * 1.35 if p else a


def sram_area_mm2(size_bytes: float, block_bytes: float = 64.0,
                  ports: int = 0) -> float:
    """Bank area, mm^2 (csrc/sram_model.cc:sram_area_mm2)."""
    return _py_area(size_bytes, block_bytes, ports)


def sram_bank_model(size_bytes: float, block_bytes: float, ports: int):
    """(read nJ/access, write nJ/access, leak mW/bank)."""
    return (_py_read(size_bytes, block_bytes, ports),
            _py_write(size_bytes, block_bytes, ports),
            _py_leak(size_bytes, block_bytes, ports))

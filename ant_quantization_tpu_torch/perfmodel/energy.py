"""Energy parameter construction for the accelerator model.

The reference derives per-event energies from CACTI (SRAM banks) and a
28nm synthesis table (systolic PEs) — simulator.py:225-345. This module
reproduces that derivation from a small data table of the measured values
(the same three SRAM bank configs every accelerator variant uses, since
get_energy_cost hardcodes 32/32/1024 banks with 512/512/32-bit blocks) plus
the per-PE synthesis numbers; an analytical CACTI-style scaling model (see
csrc/sram_model.cc) covers configurations outside the table.

The port's copy of the reference's ``perfmodel/energy.py``.
"""

from __future__ import annotations

from .model import AcceleratorConfig, EnergyParams

# Measured bank data at 28nm, 360K, itrs-hp (CACTI 6.5 outputs for the
# three bank configs used by every accelerator variant):
#   (bank size bytes, block bytes, rw ports) -> (read nJ/access,
#    write nJ/access, leak mW/bank)
SRAM_BANK_TABLE = {
    (4096, 64, 0): (0.0168924, 0.0203422, 2.96594),    # wbuf: 512-bit block
    (8192, 64, 0): (0.0177688, 0.0248866, 5.4983),     # ibuf
    (128, 4, 1): (0.000294945, 0.000415925, 0.127708),  # obuf: 32-bit block
}

# 28nm synthesis, one PE (N=M=1) at 500 MHz:
#   (pmax, pmin) -> (leakage nW, dynamic nW)
PE_SYNTH_TABLE = {
    (8, 4): (64314.0, 279960.0),
    (6, 6): (28458.0, 123882.0),
}


def energy_params(acc: AcceleratorConfig) -> EnergyParams:
    """EnergyTuple equivalent (simulator.py get_energy_cost, :225-345).

    Bank geometry is fixed at 32/32/1024 banks with 512/512/32-bit blocks
    regardless of the array size, exactly as the reference hardcodes it.
    """
    wbuf_bits = ibuf_bits = 16 * 32
    obuf_bits = 32
    wbuf_bank, ibuf_bank, obuf_bank = 32, 32, 32 * 32

    wbuf_bank_size = acc.sram_wgt * 8 // (wbuf_bank * wbuf_bits) * wbuf_bits
    ibuf_bank_size = acc.sram_act * 8 // (ibuf_bank * ibuf_bits) * ibuf_bits
    obuf_bank_size = acc.sram_out * 8 // (obuf_bank * obuf_bits) * obuf_bits

    def bank(size_bits, block_bits, ports):
        key = (size_bits // 8, block_bits // 8, ports)
        if key in SRAM_BANK_TABLE:
            return SRAM_BANK_TABLE[key]
        from .sram import sram_bank_model  # analytical fallback
        return sram_bank_model(*key)

    w_rd, w_wr, w_leak = bank(wbuf_bank_size, wbuf_bits, 0)
    i_rd, i_wr, i_leak = bank(ibuf_bank_size, ibuf_bits, 0)
    o_rd, o_wr, o_leak = bank(obuf_bank_size, obuf_bits, 1)

    leak_nw, dyn_nw = PE_SYNTH_TABLE.get((acc.pmax, acc.pmin),
                                         PE_SYNTH_TABLE[(8, 4)])
    pes = acc.n * acc.m
    f = float(acc.frequency)
    core_leak = leak_nw * pes / f
    core_dyn = dyn_nw * pes / f
    sram_leak = ((w_leak * wbuf_bank + i_leak * ibuf_bank
                  + o_leak * obuf_bank) * 1e6) / f

    return EnergyParams(
        core_leak_energy=core_leak,
        core_dynamic_energy=core_dyn,
        wbuf_read_energy=w_rd / wbuf_bits,
        wbuf_write_energy=w_wr / wbuf_bits,
        ibuf_read_energy=i_rd / ibuf_bits,
        ibuf_write_energy=i_wr / ibuf_bits,
        obuf_read_energy=o_rd / obuf_bits,
        obuf_write_energy=o_wr / obuf_bits,
        sram_leak_energy=sram_leak,
    )


# conf_*.ini equivalents (ant_simulator/conf_{ant,olaccel,adafloat,
# biscaled}.ini)
CONFIGS = {
    "ant": AcceleratorConfig(n=32, m=32, pmax=8, pmin=4),
    "bitfusion": AcceleratorConfig(n=32, m=32, pmax=8, pmin=4),
    "olaccel": AcceleratorConfig(n=16, m=18, pmax=8, pmin=4),
    "adafloat": AcceleratorConfig(n=32, m=28, pmax=8, pmin=4),
    "biscaled": AcceleratorConfig(n=32, m=80, pmax=6, pmin=6),
}

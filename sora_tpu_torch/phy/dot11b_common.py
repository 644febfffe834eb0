"""802.11b DSSS constants (IEEE 802.11-2007 Clause 18).
(The port's own copy of ``sora_tpu.phy.dot11b_common``.)

Reference equivalents: Barker spread/despread bricks
(kernel/bb/Brick11/src/barkerspread.hpp), CCK encoder/decoder (cck.hpp),
PLCP framing (PHY_11b.hpp), self-synchronizing scrambler
(bbb_scramble.c / scramble.hpp TSc741).
"""

from __future__ import annotations

import numpy as np

from sora_tpu_torch.dsp.crc import crc16_bits

CHIP_RATE = 11_000_000          # chips/s
BARKER = np.array([1, -1, 1, 1, -1, 1, 1, 1, -1, -1, -1], dtype=np.float64)

# PLCP long-preamble constants (Clause 18.2.3)
SYNC_BITS = 128                  # scrambled ones
SFD_LONG = 0xF3A0                # transmitted LSB first after the sync
SCRAMBLER_SEED_LONG = 0x6C       # Clause 18.2.4: 1101100 (x7..x1)

# PLCP short-preamble constants (Clause 18.2.5): 56 scrambled ZEROS, the
# time-reversed SFD, then the 48-bit header at 2 Mbps DQPSK.  The
# reference carries the mode as preamble_type 0=LONG 1=SHORT through the
# 11b context (kernel/bb/Brick11/src/PHY_11b.hpp:26).
SYNC_BITS_SHORT = 56             # scrambled zeros
SFD_SHORT = 0x05CF               # bit-reverse of SFD_LONG
SCRAMBLER_SEED_SHORT = 0x1B      # Clause 18.2.5.2: 0011011

SIGNAL_BYTE = {1: 0x0A, 2: 0x14, 5.5: 0x37, 11: 0x6E}
RATE_BY_SIGNAL = {v: k for k, v in SIGNAL_BYTE.items()}

# DQPSK differential phase per dibit (d0 d1), Clause 18.4.6.4
DQPSK_PHASE = {(0, 0): 0.0, (0, 1): np.pi / 2,
               (1, 1): np.pi, (1, 0): 3 * np.pi / 2}

# CCK phase tables (Clause 18.4.6.5)
# phi2/3/4 for 11 Mbps from dibits (QPSK map: 00->0 01->pi/2 10->-pi/2? no:)
CCK_DIBIT_PHASE = {(0, 0): 0.0, (0, 1): np.pi / 2,
                   (1, 0): np.pi, (1, 1): 3 * np.pi / 2}


def scramble_11b(bits: np.ndarray, seed: int = SCRAMBLER_SEED_LONG
                 ) -> np.ndarray:
    """Self-synchronizing TX scrambler: out = in ^ s4 ^ s7 where s is the
    shift register of *output* bits (polynomial z^-4 + z^-7)."""
    reg = [(seed >> i) & 1 for i in range(7)]      # reg[0]=z^-1 .. reg[6]=z^-7
    out = np.zeros_like(bits)
    for i, b in enumerate(bits):
        o = b ^ reg[3] ^ reg[6]
        out[i] = o
        reg = [o] + reg[:6]
    return out


def descramble_11b(bits: np.ndarray, seed: int = 0) -> np.ndarray:
    """Self-synchronizing RX descrambler: out = in ^ r4 ^ r7 where r is the
    shift register of *received* bits; synchronizes itself after 7 bits."""
    reg = [(seed >> i) & 1 for i in range(7)]
    out = np.zeros_like(bits)
    for i, b in enumerate(bits):
        out[i] = b ^ reg[3] ^ reg[6]
        reg = [b] + reg[:6]
    return out


def cck_codeword(phi1: float, phi2: float, phi3: float, phi4: float
                 ) -> np.ndarray:
    """8-chip CCK codeword (Clause 18.4.6.5 eq. 18-11)."""
    c = np.exp(1j * np.array([
        phi1 + phi2 + phi3 + phi4,
        phi1 + phi3 + phi4,
        phi1 + phi2 + phi4,
        phi1 + phi4,
        phi1 + phi2 + phi3,
        phi1 + phi3,
        phi1 + phi2,
        phi1,
    ]))
    c[3] = -c[3]
    c[6] = -c[6]
    return c


def cck11_codebook() -> np.ndarray:
    """All 64 (phi2,phi3,phi4) codewords with phi1 = 0: (64, 8) complex.
    The RX correlator bank (TCCK11Decoder's correlator, cck.hpp:210+)
    scores these and resolves phi1 differentially."""
    book = np.zeros((64, 8), dtype=np.complex128)
    for i in range(64):
        d = [(i >> k) & 1 for k in range(6)]
        p2 = CCK_DIBIT_PHASE[(d[0], d[1])]
        p3 = CCK_DIBIT_PHASE[(d[2], d[3])]
        p4 = CCK_DIBIT_PHASE[(d[4], d[5])]
        book[i] = cck_codeword(0.0, p2, p3, p4)
    return book


def cck55_codebook() -> np.ndarray:
    """The 4 (d2,d3) codewords with phi1 = 0 for 5.5 Mbps:
    phi2 = d2*pi + pi/2, phi3 = 0, phi4 = d3*pi (Clause 18.4.6.6)."""
    book = np.zeros((4, 8), dtype=np.complex128)
    for i in range(4):
        d2, d3 = i & 1, (i >> 1) & 1
        book[i] = cck_codeword(0.0, d2 * np.pi + np.pi / 2, 0.0, d3 * np.pi)
    return book


def crc16_plcp(bits: np.ndarray) -> int:
    """CRC-16 over the PLCP header bit stream (x^16+x^12+x^5+1, init all
    ones, ones-complement), bit-serial as transmitted: it is
    :func:`sora_tpu_torch.dsp.crc.crc16_bits`."""
    return crc16_bits(bits)

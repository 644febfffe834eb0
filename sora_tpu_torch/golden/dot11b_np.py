"""Pure-numpy golden model of the 802.11b DSSS PHY (TX + RX) — the port's
own copy of ``sora_tpu.golden.dot11b_np``.

Functional equivalent of the reference 11b brick graphs
(kernel/bb/demod11/fb11bmod_config.hpp / fb11bdemod_config.hpp:92-142):
TX: TBB11bSrc -> TSc741 scramble -> {DBPSK/DQPSK Barker spread | CCK
encode}; RX: energy detect -> despread/correlate -> differential demod ->
descramble -> PLCP parse (CRC16) -> payload -> FCS.

Sample rate convention: 11 Msps complex chips (1 sample/chip) — the
reference's post-decimation rate after TSymTiming picks the chip phase
from its 44 Msps input (symtiming.hpp).  A 2x-oversampled RX entry point
handles timing selection.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sora_tpu_torch.mac.frame import fcs32
from sora_tpu_torch.phy import dot11b_common as B

# =============================================================================
# Transmitter
# =============================================================================


def _bits_lsb(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")


def _dbpsk_phases(bits: np.ndarray, phi0: float = 0.0) -> np.ndarray:
    """Differential BPSK: bit 1 flips phase by pi."""
    dphi = np.pi * bits
    return phi0 + np.cumsum(dphi)


def _dqpsk_phases(dibits: np.ndarray, phi0: float = 0.0) -> np.ndarray:
    dphi = np.array([B.DQPSK_PHASE[(int(a), int(b))] for a, b in dibits])
    return phi0 + np.cumsum(dphi)


def plcp_header_bits(rate_mbps: float, psdu_len: int) -> np.ndarray:
    """SIGNAL, SERVICE, LENGTH, CRC16 — 48 bits, LSB-first fields."""
    signal = B.SIGNAL_BYTE[rate_mbps]
    length_us = int(np.ceil(psdu_len * 8 / rate_mbps))
    service = 0x04                        # locked clocks
    if rate_mbps == 11:
        le = int(np.ceil(psdu_len * 8 / 11)) * 11 - psdu_len * 8 >= 8
        if le:
            service |= 0x80
    hdr = np.zeros(48, dtype=np.uint8)
    hdr[0:8] = [(signal >> i) & 1 for i in range(8)]
    hdr[8:16] = [(service >> i) & 1 for i in range(8)]
    hdr[16:32] = [(length_us >> i) & 1 for i in range(16)]
    crc = B.crc16_plcp(hdr[:32])
    hdr[32:48] = [(crc >> i) & 1 for i in range(16)]
    return hdr


def modulate(psdu: bytes, rate_mbps: float,
             preamble: str = "long") -> np.ndarray:
    """PSDU -> 11 Msps complex chips, long or short preamble format
    (the preamble_type 0=LONG / 1=SHORT contract of PHY_11b.hpp:26)."""
    psdu_bits = _bits_lsb(psdu)
    if preamble == "short":
        # Clause 18.2.5: 56 scrambled zeros + reversed SFD at 1 Mbps
        # DBPSK, then the 48-bit header at 2 Mbps DQPSK; 1 Mbps data
        # does not exist in the short format
        if rate_mbps == 1:
            raise ValueError("short preamble excludes 1 Mbps data")
        pre = np.concatenate([
            np.zeros(B.SYNC_BITS_SHORT, np.uint8),
            np.array([(B.SFD_SHORT >> i) & 1 for i in range(16)],
                     np.uint8),
        ])
        hdr = plcp_header_bits(rate_mbps, len(psdu))
        plcp = B.scramble_11b(np.concatenate([pre, hdr]),
                              seed=B.SCRAMBLER_SEED_SHORT)
        ph_pre = _dbpsk_phases(plcp[:len(pre)])
        ph_hdr = _dqpsk_phases(plcp[len(pre):].reshape(-1, 2),
                               ph_pre[-1])
        phases = np.concatenate([ph_pre, ph_hdr])
        chips = [np.exp(1j * phases[:, None]) * B.BARKER[None, :]]
        phi = phases[-1]
        data_scrambled = _scramble_continue(plcp, psdu_bits)
        if rate_mbps == 2:
            ph = _dqpsk_phases(data_scrambled.reshape(-1, 2), phi)
            chips.append(np.exp(1j * ph[:, None]) * B.BARKER[None, :])
        else:
            chips.append(_cck_modulate(data_scrambled, rate_mbps, phi))
        return np.concatenate([c.reshape(-1) for c in chips])
    # PLCP preamble+header, scrambled as one stream
    pre = np.concatenate([
        np.ones(B.SYNC_BITS, np.uint8),
        np.array([(B.SFD_LONG >> i) & 1 for i in range(16)], np.uint8),
    ])
    hdr = plcp_header_bits(rate_mbps, len(psdu))
    plcp = B.scramble_11b(np.concatenate([pre, hdr]))
    # preamble+header always DBPSK/Barker at 1 Mbps
    phases = _dbpsk_phases(plcp)
    chips = [np.exp(1j * phases[:, None]) * B.BARKER[None, :]]
    phi = phases[-1]
    # data section
    data_scrambled = _scramble_continue(plcp, psdu_bits)
    if rate_mbps == 1:
        ph = _dbpsk_phases(data_scrambled, phi)
        chips.append(np.exp(1j * ph[:, None]) * B.BARKER[None, :])
    elif rate_mbps == 2:
        ph = _dqpsk_phases(data_scrambled.reshape(-1, 2), phi)
        chips.append(np.exp(1j * ph[:, None]) * B.BARKER[None, :])
    elif rate_mbps in (5.5, 11):
        chips.append(_cck_modulate(data_scrambled, rate_mbps, phi))
    else:
        raise ValueError(rate_mbps)
    return np.concatenate([c.reshape(-1) for c in chips])


def _scramble_continue(prev_scrambled: np.ndarray, bits: np.ndarray
                       ) -> np.ndarray:
    """Continue the self-sync scrambler with register state = the last 7
    scrambler *output* bits already transmitted."""
    reg_seed = 0
    for i in range(7):
        reg_seed |= int(prev_scrambled[-1 - i]) << i
    return B.scramble_11b(bits, reg_seed)


def _cck_modulate(bits: np.ndarray, rate_mbps: float, phi0: float
                  ) -> np.ndarray:
    nbps = 4 if rate_mbps == 5.5 else 8
    groups = bits.reshape(-1, nbps)
    out = np.zeros((len(groups), 8), dtype=np.complex128)
    phi = phi0
    for k, g in enumerate(groups):
        # phi1: DQPSK on (d0, d1), with extra pi on odd symbols
        dphi = B.DQPSK_PHASE[(int(g[0]), int(g[1]))]
        if k % 2 == 1:
            dphi += np.pi
        phi = phi + dphi
        if rate_mbps == 5.5:
            d2, d3 = int(g[2]), int(g[3])
            cw = B.cck_codeword(phi, d2 * np.pi + np.pi / 2, 0.0, d3 * np.pi)
        else:
            p2 = B.CCK_DIBIT_PHASE[(int(g[2]), int(g[3]))]
            p3 = B.CCK_DIBIT_PHASE[(int(g[4]), int(g[5]))]
            p4 = B.CCK_DIBIT_PHASE[(int(g[6]), int(g[7]))]
            cw = B.cck_codeword(phi, p2, p3, p4)
        out[k] = cw
    return out


# =============================================================================
# Receiver
# =============================================================================


@dataclass
class RxResult:
    ok: bool = False
    reason: str = "no_frame"
    rate_mbps: float = 0.0
    length_us: int = 0
    psdu: bytes = b""
    fcs_ok: bool = False
    start_chip: int = -1


def _barker_demod(x: np.ndarray, nsym: int, start: int):
    """Despread nsym 11-chip symbols from chip stream at `start`;
    returns complex correlator outputs (the TBB11bDespread analogue,
    barkerspread.hpp:229)."""
    seg = x[start: start + 11 * nsym].reshape(-1, 11)
    return seg @ B.BARKER


def demodulate(x: np.ndarray, oversample: int = 1) -> RxResult:
    """Decode one 802.11b long-preamble frame from a chip-rate (or
    2x-oversampled) stream."""
    res = RxResult()
    if oversample > 1:
        # decimation-phase selection à la TSymTiming: strongest Barker
        # correlation energy wins
        best, best_e = 0, -1.0
        for ph in range(oversample):
            xx = x[ph::oversample]
            c = np.abs(_corr_stream(xx[: 3000]))
            e = float(np.sort(c)[-50:].sum())
            if e > best_e:
                best, best_e = ph, e
        x = x[best::oversample]
    # symbol timing: Barker correlation peak modulo 11
    c = _corr_stream(x[: min(len(x), 4000)])
    mag = np.abs(c)
    folds = np.array([mag[k::11].sum() for k in range(11)])
    t0 = int(np.argmax(folds))
    res.start_chip = t0
    nsym_avail = (len(x) - t0) // 11
    if nsym_avail < 110:
        return res
    corr = _barker_demod(x, nsym_avail, t0)
    # DBPSK demod over the whole stream (differential)
    d = corr[1:] * np.conj(corr[:-1])
    bits = (np.real(d) < 0).astype(np.uint8)   # pi flip => bit 1
    # first symbol has no reference; prepend assuming sync bit
    bits = np.concatenate([[1], bits])
    # hunt the SFD in the descrambled stream: long first, else the
    # reversed short-preamble SFD (Clause 18.2.5 / PHY_11b.hpp:26)
    desc = B.descramble_11b(bits)
    sfd = np.array([(B.SFD_LONG >> i) & 1 for i in range(16)], np.uint8)
    pos = _find_pattern(desc, sfd, limit=B.SYNC_BITS + 64)
    short = False
    if pos < 0:
        sfd_s = np.array([(B.SFD_SHORT >> i) & 1 for i in range(16)],
                         np.uint8)
        pos = _find_pattern(desc, sfd_s,
                            limit=B.SYNC_BITS_SHORT + 64)
        short = pos >= 0
    if pos < 0:
        res.reason = "no_sfd"
        return res
    if short:
        # 48 header bits on 24 DQPSK symbols at 2 Mbps
        hs = pos + 16
        if hs + 24 >= len(corr):
            res.reason = "truncated"
            return res
        cs = corr[hs - 1: hs + 24]
        dh = cs[1:] * np.conj(cs[:-1])
        q = np.round(np.angle(dh) / (np.pi / 2)).astype(int) % 4
        demap = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.uint8)
        raw_hdr = demap[q].reshape(-1)
        seed = 0
        for i in range(7):
            seed |= int(bits[hs - 1 - i]) << i
        hdr = B.descramble_11b(raw_hdr, seed)
        hdr_end_sym = hs + 24
        data_prev7 = raw_hdr[-7:]
    else:
        hdr_start = pos + 16
        if hdr_start + 48 > len(desc):
            res.reason = "truncated"
            return res
        hdr = desc[hdr_start: hdr_start + 48]
        hdr_end_sym = hdr_start + 48
        data_prev7 = bits[hdr_end_sym - 7: hdr_end_sym]
    crc = B.crc16_plcp(hdr[:32])
    rx_crc = int(np.sum(hdr[32:48].astype(np.int64) << np.arange(16)))
    if crc != rx_crc:
        res.reason = "plcp_header_fail"
        return res
    signal = int(np.sum(hdr[0:8].astype(np.int64) << np.arange(8)))
    if signal not in B.RATE_BY_SIGNAL:
        res.reason = "bad_signal"
        return res
    rate = B.RATE_BY_SIGNAL[signal]
    res.rate_mbps = rate
    length_us = int(np.sum(hdr[16:32].astype(np.int64) << np.arange(16)))
    res.length_us = length_us
    service = int(np.sum(hdr[8:16].astype(np.int64) << np.arange(8)))
    # data region starts after header symbols
    data_sym0 = t0 + 11 * hdr_end_sym
    nbits = int(rate * length_us)
    if rate == 11 and (service & 0x80):
        nbits -= 8
    nbytes = nbits // 8
    # register state for descrambler continuity = last 7 received bits
    if rate in (1, 2):
        if rate == 1:
            nsym = nbytes * 8
            need = data_sym0 + 11 * nsym
            if need > len(x):
                res.reason = "truncated"
                return res
            corr_d = _barker_demod(x, nsym, data_sym0)
            ref = _barker_demod(x, 1, data_sym0 - 11)[0]
            d = np.concatenate([[corr_d[0] * np.conj(ref)],
                                corr_d[1:] * np.conj(corr_d[:-1])])
            raw = (np.real(d) < 0).astype(np.uint8)
        else:
            nsym = nbytes * 8 // 2
            need = data_sym0 + 11 * nsym
            if need > len(x):
                res.reason = "truncated"
                return res
            corr_d = _barker_demod(x, nsym, data_sym0)
            ref = _barker_demod(x, 1, data_sym0 - 11)[0]
            prev = np.concatenate([[ref], corr_d[:-1]])
            d = corr_d * np.conj(prev)
            ang = np.angle(d)
            q = np.round(ang / (np.pi / 2)).astype(int) % 4
            demap = {0: (0, 0), 1: (0, 1), 2: (1, 1), 3: (1, 0)}
            raw = np.array([demap[v] for v in q], np.uint8).reshape(-1)
    else:
        raw = _cck_demod(x, data_sym0, rate, nbytes)
        if raw is None:
            res.reason = "truncated"
            return res
    # descramble with register seeded by the last 7 raw bits before data
    seed = 0
    for i in range(7):
        seed |= int(data_prev7[-1 - i]) << i
    data = B.descramble_11b(raw, seed)
    psdu = np.packbits(data[: nbytes * 8], bitorder="little").tobytes()
    res.psdu = psdu
    res.fcs_ok = len(psdu) >= 4 and fcs32(psdu[:-4]) == int.from_bytes(
        psdu[-4:], "little")
    res.ok = res.fcs_ok
    res.reason = "frame_ok" if res.ok else "crc32_fail"
    return res


def _cck_demod(x: np.ndarray, start: int, rate: float, nbytes: int):
    nbps = 4 if rate == 5.5 else 8
    nsym = nbytes * 8 // nbps
    if start + 8 * nsym > len(x):
        return None
    book = B.cck55_codebook() if rate == 5.5 else B.cck11_codebook()
    sym = x[start: start + 8 * nsym].reshape(-1, 8)
    # phase reference: last Barker header symbol
    ref = _barker_demod(x, 1, start - 11)[0]
    ref = ref / (np.abs(ref) + 1e-12)
    bits = np.zeros(nsym * nbps, np.uint8)
    phi_prev = np.angle(ref)
    inv_map = {v: k for k, v in B.DQPSK_PHASE.items()}
    for k in range(nsym):
        sc = sym[k] @ np.conj(book).T           # (ncw,)
        iw = int(np.argmax(np.abs(sc)))
        phi1 = np.angle(sc[iw])
        dphi = (phi1 - phi_prev) % (2 * np.pi)
        if k % 2 == 1:
            dphi -= np.pi
        qd = int(np.round(dphi / (np.pi / 2))) % 4
        d0, d1 = inv_map[qd * np.pi / 2]
        g = [d0, d1]
        if rate == 5.5:
            g += [iw & 1, (iw >> 1) & 1]
        else:
            g += [(iw >> i) & 1 for i in range(6)]
        bits[k * nbps: (k + 1) * nbps] = g
        phi_prev = phi1
    return bits


def _corr_stream(x: np.ndarray) -> np.ndarray:
    if len(x) < 11:
        return np.zeros(0, dtype=complex)
    return np.correlate(x, B.BARKER, "valid")


def _find_pattern(bits: np.ndarray, pat: np.ndarray, limit: int) -> int:
    n = min(len(bits) - len(pat), limit)
    for i in range(max(n, 0)):
        if np.array_equal(bits[i: i + len(pat)], pat):
            return i
    return -1

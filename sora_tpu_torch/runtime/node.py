"""Live streaming SDR node: RX ring(s) -> batched device decode -> soft MAC
-> pre-staged TX (port of ``sora_tpu.runtime.node``, phy "a", "b" and
"n").

This is the umxsdrbrick analogue — the reference's defining capability: a
*running radio* (kernel/bb/umxsdrbrick/main.cpp).  `Dot11_main` boots the
radio, maps the RX DMA ring, starts RX/Viterbi/TX threads, and the MAC
polls the demod graph (dot11main.cpp:365-457, mac.cpp:190-345,
rxstream.hpp:37-64).  Here the thread pipeline becomes a windowed,
double-buffered device feed:

* The native ring (``runtime.native.RxRing``) is the
  SORA_RADIO_RX_STREAM: a producer thread (paced replay, or live writes)
  fills it; the node is a vstream reader.  11n reads TWO rings — the
  dual-radio TRxMIMOStream (rxstream.hpp:162, dot11main.cpp:270-276).
* Samples accumulate into fixed-shape overlapping windows; the native
  reader assembles and quantizes a batch of windows in one pass, only the
  int16/int8 wire crosses to the card (``util.xfer.device_quantized``),
  and the phy's auto pipeline decodes the batch (the whole RX graph: one
  launch of the Viterbi kernel for 11a; none for 11b, whose chips run
  through the DSSS receiver, after the chip front end for 40/44 Msps
  input; for 11n two per pipeline, HT-SIG and data, and with no fixed MCS
  both stream classes' pipelines run, the per-row winner taken by which
  closed its FCS).
* Every device result is fetched through a ``util.xfer.Pending`` started
  when the work is issued: the node issues batch k+1's carrier-sense pass
  before it waits for batch k's, and a wait covers only the copies of the
  result it needs — not the work queued after them (a blocking ``.cpu()``
  would wait for the whole stream and undo the double buffer).
* A cheap carrier-sense pass (``detect_only``: the STS plateau for 11a,
  the Barker fold for 11b, on the antenna sum for 11n) gates the full
  decode — TCCA11a's no-energy early exit
  (cca.hpp:165-230): idle air costs the sync front end only, never the
  Viterbi.
* Decoded data frames are ACKed from a precomputed-waveform SignalCache
  (sub-SIFS fire, _signal_cache.h:1-60; the waveforms come from the
  port's 11a or 11b TX on the node's device — 11n control responses go
  out in legacy OFDM) into a TX sink that can loop back into ring(s) (the
  software air) or just stage waveforms.

The host MAC logic (windows, AGC, dedup, the TX FSM, mgmt, beacons,
reconfigure, skip_backlog, flush) is the JAX package's, copied.
:class:`NodeConfig` sizes all three PHYs as the JAX package does.  The
node runs on ``device`` (default cuda; raises without CUDA unless
``device="cpu"``).

Error taxonomy mirrors the reference's err_stat[] status page
(umxsdrbrick/mgmt.h:81): cs_timeout / plcp_fail / crc_fail / frame_ok...
"""

from __future__ import annotations

import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from sora_tpu_torch.mac import mgmt
from sora_tpu_torch.mac.csma import (CW_MAX, CW_MIN, DIFS_SLOTS,
                                     RETRY_LIMIT, SignalCache)
from sora_tpu_torch.mac.frame import MacHeader, append_fcs, build_ack_frame
from sora_tpu_torch.phy import common as C
from sora_tpu_torch.phy import dot11n_common as NC
from sora_tpu_torch.phy import frontend as fe
from sora_tpu_torch.phy.dot11a import rx as arx
from sora_tpu_torch.phy.dot11a import tx as atx
from sora_tpu_torch.phy.dot11b import rx as brx
from sora_tpu_torch.phy.dot11b import tx as btx
from sora_tpu_torch.phy.dot11n import rx as nrx
from sora_tpu_torch.util.stopwatch import MacStopwatch
from sora_tpu_torch.util.xfer import (I8_SCALE, I16_SCALE, Pending,
                                      device_complex8, device_complex16,
                                      device_quantized, fetch,
                                      resolve_device, upload)


def frame_span_samples(phy: str, psdu_len: int, rate: float,
                       input_rate: str = "20m") -> int:
    """Input-rate samples spanned by one frame of ``psdu_len`` bytes at
    ``rate`` (Mbps for OFDM, Mbps for DSSS, MCS index for 11n)."""
    if phy == "b":
        chips = btx.waveform_len(rate, psdu_len)
        mult = {"11m": 1.0, "40m": 40.0 / 11.0, "44m": 4.0}[input_rate]
        return int(np.ceil(chips * mult))
    if phy == "n":
        m = NC.mcs_param(int(rate))
        nsym = -(-(16 + 8 * psdu_len + 6) // m.ndbps)
        pre = 720 if m.nss == 1 else 800
        n = pre + 80 * nsym          # L+HT preambles + HT-SIG + symbols
    else:
        nsym = -(-(16 + 8 * psdu_len + 6) // C.RATES[int(rate)].ndbps)
        n = 320 + 80 * (nsym + 1)    # preamble + SIGNAL + data symbols
    mult = {"20m": 1.0, "40m": 2.0, "44m": 2.2}[input_rate]
    return int(np.ceil(n * mult))


@dataclass
class NodeConfig:
    phy: str = "a"                # "a" | "b" | "n" (main.cpp:28-39 -b/-n)
    window: int = 0               # samples per decode window (0 = auto)
    batch: int = 8                # windows per device batch
    overlap: int = 0              # window overlap (0 = auto >= frame span)
    input_rate: str = "20m"  # a/n: "20m"|"40m"|"44m"; b: "11m"|"40m"|"44m"
    max_psdu: int = 2500  # reference MTU (PHY_11a.hpp:571)
    rate_mbps: float | None = None  # None = auto dispatch (11a/11b)
    mcs: int | None = None        # 11n: None = mixed-MCS auto dispatch
    min_rate_mbps: float | None = None  # slowest rate expected on air
    max_frames_per_window: int = 0  # decode candidates per window (0 = auto)
    decode_slots: int = 0         # decode-tail rows per batch (0 = auto):
    # the candidate-compaction bucket — only this many highest-det
    # candidates of a batch pay extract/demap/Viterbi; -1 disables
    ack_rate: float | None = None  # None = per-phy default (6 OFDM / 2 DSSS)
    addr: bytes = b"\x02SORA1"
    sample_rate_sps: float = 20e6
    detect_threshold: float | None = None  # None = per-phy default
    promiscuous: bool = False     # sniffer mode: log every frame, no ACKs
    backlog_hwm: int = 0          # ring backlog watchdog (0 = auto)
    data_rate: float | None = None  # TX data rate (None = ack_rate)
    ack_timeout_slots: int = 0    # 0 = auto from batch decode latency
    beacon_interval_s: float = 0.0  # 0 = no beacons (AP mode off)
    ssid: str = "sora-tpu"
    agc: bool = True              # closed-loop software RX gain
    agc_target: float = 1.0       # post-gain frame amplitude target
    wire: str = "i16"             # host->device sample wire: "i16" (the
    # COMPLEX16 DMA convention) | "i8" (half the bytes again; the AGC
    # holds the signal at the 8-bit quantizer's design amplitude)

    def __post_init__(self):
        if self.phy not in ("a", "b", "n"):
            raise ValueError(f"phy must be a|b|n, got {self.phy!r}")
        if self.wire not in ("i16", "i8"):
            raise ValueError(f"wire must be i16|i8, got {self.wire!r}")
        if self.ack_rate is None:
            self.ack_rate = 2 if self.phy == "b" else 6
        if self.detect_threshold is None:
            # OFDM STS plateau quality in [0,1]; DSSS Barker fold ratio
            # in [~1, 11]
            self.detect_threshold = 1.7 if self.phy == "b" else 0.6
        if self.min_rate_mbps is None:
            self.min_rate_mbps = ({"a": 6, "b": 1, "n": 8}[self.phy]
                                  if self.rate_mbps is None
                                  else self.rate_mbps)
        # ---- window/overlap auto-sizing.  A frame is guaranteed to land
        # fully inside at least one window iff overlap >= its sample span;
        # hop > 0 needs window > overlap.
        span = frame_span_samples(
            self.phy, self.max_psdu,
            self.mcs if (self.phy == "n" and self.mcs is not None)
            else self.min_rate_mbps, self.input_rate)
        auto_overlap = self.overlap == 0
        if auto_overlap:
            self.overlap = -(-span // 1024) * 1024
        if self.window == 0:
            self.window = 1 << int(np.ceil(np.log2(
                max(2 * self.overlap, 8192))))
        if auto_overlap and self.overlap >= self.window:
            # an explicit small window caps the auto overlap; the span
            # warning below still fires
            self.overlap = self.window - max(1, self.window // 4)
        if self.overlap >= self.window:
            raise ValueError(
                f"overlap {self.overlap} must be < window {self.window}")
        if self.overlap < span:
            warnings.warn(
                f"overlap {self.overlap} < max frame span {span} samples "
                f"({self.max_psdu}B at rate {self.min_rate_mbps}): a "
                "max-size min-rate frame straddling a window boundary "
                "would be lost; raise overlap/window, lower max_psdu, or "
                "set min_rate_mbps to the slowest rate actually on air",
                stacklevel=2)
        if self.max_frames_per_window == 0:
            if self.phy == "a" and self.rate_mbps is None:
                # enough candidates for back-to-back min-size data
                # frames over one hop, capped to keep decode cost sane
                hop = self.window - self.overlap
                min_span = frame_span_samples(self.phy, 28, 54,
                                              self.input_rate)
                self.max_frames_per_window = max(
                    1, min(8, -(-hop // max(1, min_span))))
            else:
                self.max_frames_per_window = 1
        if self.decode_slots <= 0:
            # default: every candidate slot decodes (correct under any
            # load).  Sparse live air should set an explicit bucket
            # (e.g. 4*batch): only that many highest-det candidates per
            # batch pay extract/demap/Viterbi, and the tail cost scales
            # with frames present instead of with batch*K slots.
            self.decode_slots = self.batch * self.max_frames_per_window
        else:
            self.decode_slots = min(
                self.decode_slots,
                self.batch * self.max_frames_per_window)


@dataclass
class ErrStats:
    """err_stat[] + print_status analogue (mgmt.h:81)."""
    windows: int = 0
    cs_timeout: int = 0           # windows with no carrier detected
    decoded_batches: int = 0
    frame_ok: int = 0
    plcp_fail: int = 0
    crc_fail: int = 0
    truncated: int = 0            # frame runs past the window end; it
    # decodes from the next overlapping window (boundary accounting)
    compaction_drop: int = 0      # above-threshold candidates dropped by
    # the decode_slots top-k (decode capacity, NOT a channel error)
    dup: int = 0
    not_for_us: int = 0
    acks_tx: int = 0
    tx_data: int = 0              # data frames fired (MAC11_Send)
    tx_acked: int = 0             # data frames confirmed by an ACK
    tx_retries: int = 0           # BEB retransmissions
    tx_drops: int = 0             # gave up after RETRY_LIMIT
    beacons_tx: int = 0           # AP-mode beacons queued
    mgmt_rx: int = 0              # auth/assoc/beacon frames handled
    ring_drops: list = field(default_factory=list)   # per-vstream counts
    ring_resync: int = 0          # antenna-stream realignments (overrun
    # between the availability pre-check and a later ring's read)
    backlog_dropped: int = 0      # samples skipped by the watchdog
    # bounded: a long-running node must not grow without limit
    ack_latency_s: "deque" = field(
        default_factory=lambda: deque(maxlen=4096))

    def status_page(self) -> str:
        lines = ["-- node status ------------------------------",
                 f" windows      {self.windows:8d}   cs_timeout "
                 f"{self.cs_timeout:8d}",
                 f" batches      {self.decoded_batches:8d}   ring_drops "
                 + ("/".join(str(d) for d in self.ring_drops)
                    if self.ring_drops else "       0"),
                 f" frame_ok     {self.frame_ok:8d}   dup        "
                 f"{self.dup:8d}",
                 f" plcp_fail    {self.plcp_fail:8d}   crc_fail   "
                 f"{self.crc_fail:8d}",
                 f" truncated    {self.truncated:8d}",
                 f" not_for_us   {self.not_for_us:8d}   acks_tx    "
                 f"{self.acks_tx:8d}",
                 f" backlog_drop {self.backlog_dropped:8d}",
                 f" tx_data      {self.tx_data:8d}   tx_acked   "
                 f"{self.tx_acked:8d}",
                 f" tx_retries   {self.tx_retries:8d}   tx_drops   "
                 f"{self.tx_drops:8d}"]
        if self.ack_latency_s:
            a = np.asarray(self.ack_latency_s)
            lines.append(f" ack latency  avg {a.mean()*1e6:7.0f} us  "
                         f"max {a.max()*1e6:7.0f} us")
        lines.append("---------------------------------------------")
        return "\n".join(lines)


class TxSink:
    """Pre-staged TX path: `stage` precomputes/fetches the waveform (the
    SoraURadioTransferEx step), `fire` sends it (SoraURadioTx / MimoTx).
    With ring(s) attached, fired waveforms mix back into the receive path
    — the software air.  A 2-ring sink duplicates the waveform onto both
    antennas (legacy-duplicate TX, the SoraURadioMimoTx analogue,
    mac.cpp:323)."""

    def __init__(self, ring=None):
        self.rings = (list(ring) if isinstance(ring, (list, tuple))
                      else ([ring] if ring is not None else []))
        self.fired: list[tuple[float, int]] = []     # (t, n_samples)

    def fire(self, wave: np.ndarray) -> None:
        self.fired.append((time.perf_counter(), len(wave)))
        for r in self.rings:
            r.write(np.asarray(wave, np.complex64))


class StreamingNode:
    """One receive chain bound to RX ring vstream(s).

    ``ring`` is a single ``RxRing`` for 11a and 11b, or a [ring0, ring1]
    pair for the 2-antenna 11n mode (TRxMIMOStream, rxstream.hpp:162).  The
    node's device work — the carrier-sense pass, the decode, the ACK
    modulation — runs on ``device`` (default cuda)."""

    def __init__(self, ring, cfg: NodeConfig | None = None,
                 tx_sink: TxSink | None = None,
                 modulate: Callable | None = None,
                 on_payload: Callable | None = None,
                 on_frame: Callable | None = None, device=None):
        self.cfg = cfg or NodeConfig()
        self.rings = (list(ring) if isinstance(ring, (list, tuple))
                      else [ring])
        if self.cfg.phy == "n" and len(self.rings) != 2:
            raise ValueError("11n mode needs two RX rings (2 antennas)")
        self.device = resolve_device(device)
        self.vss = [r.alloc_vstream() for r in self.rings]
        self.tx = tx_sink or TxSink()
        self.stats = ErrStats()
        self.sw = MacStopwatch(sample_rate=self.cfg.sample_rate_sps)
        self.on_payload = on_payload
        self.on_frame = on_frame     # sniffer tap: meta dict per rx frame
        self.rx_payloads: list[tuple[bytes, bytes]] = []
        self.cache = SignalCache(modulate or self._default_modulate())
        self._carry = [np.zeros(0, np.complex64) for _ in self.rings]
        self._abs_off = 0                   # stream position of carry[0]
        # closed-loop RX gain (the software stand-in for the radio's
        # LNA/RXVGA ladder the reference sets at boot + HwVeri's AGC,
        # dot11main.cpp:121-146 / AGC.cpp): tracked from the detect
        # pass's device-measured window power, applied at the quantizer
        self._agc_gain = 1.0
        self._agc_peak = 0.0                # tracked peak window power
        # native windowed feed: window slicing + gain + quantization as
        # one C++ pass (sora_ring_read_windows_*); falls back to the
        # Python carry path if the span exceeds the ring capacity
        self._native_feed = all(
            hasattr(r, "read_windows") for r in self.rings)
        self._backlog_hwm = (self.cfg.backlog_hwm
                             or 8 * self.cfg.batch * self.cfg.window)
        # in-flight decodes: (Pending out, metas, t0, nsamples, det)
        self._pend: list[tuple] = []
        # in-flight carrier-sense passes:
        # (xd, Pending (det, power), metas, t0, nsamples, gain)
        self._det_pend: list[tuple] = []
        self._seen: dict[tuple[bytes, int], int] = {}     # dedup (hdr, pos)
        self._seen_order: list = []
        self._decode = None
        self._detect = None
        self._prog_table: dict = {}   # (phy, rate, mcs) -> (decode, detect)
        # -- TX MAC state (MAC11_Send + send thread, mac.cpp:293-345,
        # 547-610): queue -> DIFS -> backoff -> fire -> ACK await -> BEB.
        # The FSM is clocked by consumed stream samples (_abs_off), the
        # node's notion of air time; one slot = 9 us of input samples.
        self._txq: deque = deque()
        self._tx_state = "idle"               # idle|contend|wait_ack
        self._tx_seq = 0
        self._cw = CW_MIN
        self._difs_left = 0
        self._backoff = 0
        self._busy_until = 0                  # abs sample pos medium busy
        self._tx_clock = 0                    # FSM's consumed stream pos
        self._ack_deadline = 0
        self._tx_rng = np.random.default_rng(
            int.from_bytes(self.cfg.addr[-4:], "little"))
        self._next_beacon = (time.perf_counter()
                             + (self.cfg.beacon_interval_s or 0))
        # -- mgmt plane (mgmt.cpp auth/assoc; mgmt.h:17-83) ----------------
        self.stations: dict[bytes, int] = {}   # AP: associated STA -> AID
        self.bss_seen: dict[bytes, object] = {}  # client: bssid -> Bss
        self.associated_bssid: bytes | None = None
        self._join_target: bytes | None = None
        self._slot = max(1, int(round(9e-6 * self.cfg.sample_rate_sps)))
        self._build_programs()

    # -- modulation (ACK / data waveforms at the ring's input rate) -----------

    def _default_modulate(self) -> Callable:
        dev, ir, dsss = self.device, self.cfg.input_rate, self.cfg.phy == "b"

        def modulate(psdu, rate):
            # the port's TX on the node's device, raised to the ring's
            # input rate; one host fetch per SignalCache miss.  11n
            # control responses go out in legacy OFDM.
            p = upload(np.frombuffer(bytes(psdu), np.uint8)[None], dev)
            if dsss:
                w = btx.modulate(p, rate, len(psdu))
                if ir in ("40m", "44m"):
                    w = fe.pulse_shape_11b(w)
                    if ir == "40m":
                        w = fe.resample(w, 10, 11)
            else:
                w = atx.modulate(p, int(rate), len(psdu))
                if ir == "40m":
                    w = fe.upsample2(w)
                elif ir == "44m":
                    w = fe.ofdm_upsample_44m(w)
            return fetch(w[0])
        return modulate

    # -- device programs -------------------------------------------------------

    def _prog_key(self):
        cfg = self.cfg
        return (cfg.phy, cfg.rate_mbps, cfg.mcs)

    def _build_programs(self):
        """Install the decode/detect programs for the current config from
        the program table — live reconfiguration (process_kb,
        dot11main.cpp:148-204) then costs a dict lookup on a second
        switch to the same program."""
        key = self._prog_key()
        prog = self._prog_table.get(key)
        if prog is None:
            prog = {"a": self._build_a, "b": self._build_b,
                    "n": self._build_n}[self.cfg.phy]()
            self._prog_table[key] = prog
        self._decode, self._detect = prog

    def reconfigure(self, warm: bool = False, **changes):
        """Switch rate / MCS / PHY / thresholds on a running node — the
        interactive runtime reconfig of the reference UI loop
        (dot11main.cpp:148-204).  Structural knobs (phy, rate_mbps, mcs)
        swap in a decode program from the table (building + optionally
        warming it on first use); scalar knobs apply immediately.
        In-flight batches finish under the old program."""
        allowed = {"phy", "rate_mbps", "mcs", "detect_threshold",
                   "promiscuous", "data_rate", "ack_rate"}
        bad = set(changes) - allowed
        if bad:
            raise ValueError(f"cannot reconfigure {sorted(bad)} live "
                             f"(allowed: {sorted(allowed)})")
        if changes.get("phy") == "n" and len(self.rings) != 2:
            raise ValueError("phy='n' needs two RX rings")
        if "phy" in changes and changes["phy"] not in ("a", "b", "n"):
            raise ValueError("phy must be a|b|n")
        structural = {"phy", "rate_mbps", "mcs"} & set(changes)
        for k, v in changes.items():
            setattr(self.cfg, k, v)
        if structural:
            self._build_programs()
            if warm:
                self.warm_up()

    def _build_a(self):
        cfg = self.cfg
        if cfg.rate_mbps is None:
            nd = (cfg.decode_slots
                  if cfg.decode_slots < cfg.batch * cfg.max_frames_per_window
                  else 0)
            kw = dict(max_psdu=cfg.max_psdu, input_rate=cfg.input_rate,
                      n_frames=cfg.max_frames_per_window, n_decode=nd,
                      det_threshold=float(cfg.detect_threshold),
                      min_rate_mbps=int(cfg.min_rate_mbps))

            def decode(xb):
                return arx.rx_pipeline_auto(xb, **kw)
        else:
            rate, mp, ir = int(cfg.rate_mbps), cfg.max_psdu, cfg.input_rate

            def decode(xb):
                return arx.rx_pipeline(xb, rate, max_psdu=mp, input_rate=ir)

        def detect(xb, ir=cfg.input_rate):
            return arx.detect_only(fe.ofdm_frontend(xb, ir))

        return decode, detect

    def _build_b(self):
        cfg = self.cfg
        to_chips = {"44m": fe.chip_frontend_44m,
                    "40m": fe.chip_frontend_40m}.get(cfg.input_rate,
                                                     lambda xb: xb)
        max_psdu = min(cfg.max_psdu, 2048)
        if cfg.rate_mbps is not None:
            rate = cfg.rate_mbps

            def decode(xb):
                out = brx.rx_pipeline(to_chips(xb), rate, max_psdu=max_psdu)
                return ("b_known", out, rate)
        else:
            # one-pass runtime rate dispatch (TBB11bRxRateSel,
            # PHY_11b.hpp:378-463): all four rates decode on the card with
            # a per-frame select, so the double buffer never waits between
            # the PLCP and the data
            def decode(xb):
                out = brx.rx_pipeline_auto(to_chips(xb), max_psdu=max_psdu)
                out["sig_ok"] = out.pop("plcp_ok")
                out["pos"] = out.pop("data_chip0")
                return out

        return decode, (lambda xb: brx.detect_only(to_chips(xb)))

    @staticmethod
    def _norm_b(host: dict, rate) -> dict:
        """The fixed-rate 11b result in the node's result form."""
        host["sig_ok"] = host.pop("plcp_ok")
        host["rate_mbps"] = np.full(len(host["ok"]), float(rate), np.float32)
        host["pos"] = host.pop("data_chip0")
        return host

    def _build_n(self):
        cfg = self.cfg
        ir, mp = cfg.input_rate, cfg.max_psdu

        def front(xb):
            B, A, n = xb.shape
            return fe.ofdm_frontend(xb.reshape(B * A, n), ir).reshape(
                B, A, -1)

        if cfg.mcs is not None and int(cfg.mcs) < 8:
            mcs = int(cfg.mcs)

            def decode(xb):
                # single-spatial-stream set (MCS 0-7): one HT-LTF, MRC
                return nrx.rx_pipeline_1ss(front(xb), mcs, max_psdu=mp)
        elif cfg.mcs is not None:
            mcs = int(cfg.mcs)

            def decode(xb):
                return nrx.rx_pipeline(front(xb), mcs, max_psdu=mp)
        else:
            def decode(xb):
                # full HT auto: both stream classes decode (MCS 8-15 via
                # the 2x2 program, MCS 0-7 via the one-HT-LTF MRC program)
                # and _retire takes the per-row winner by which closed
                xf = front(xb)
                return ("n_both", nrx.rx_pipeline_auto(xf, max_psdu=mp),
                        nrx.rx_pipeline_auto_1ss(xf, max_psdu=mp))

        def detect(xb):
            # the cheap gate on the antenna SUM, as the sync sums the
            # antennas: a fade on one cannot gate out a frame the other
            # still carries
            return arx.detect_only(front(xb).sum(dim=1) * 0.5)

        return decode, detect

    def warm_up(self) -> None:
        """Build the device programs' tables and the Viterbi kernel on a
        zero batch (dot11main's graph build, before the radio starts),
        then wait for the device."""
        zd = device_complex16(np.zeros(self._batch_shape(), np.complex64),
                              self.device)
        out = self._decode(zd)
        oks = ([o["ok"] for o in out[1:] if isinstance(o, dict)]
               if isinstance(out, tuple)        # the b_known, n_both forms
               else out["ok"])
        Pending((self._detect(zd), oks)).get()

    def _batch_shape(self):
        cfg = self.cfg
        if cfg.phy == "n":
            return (cfg.batch, 2, cfg.window)
        return (cfg.batch, cfg.window)

    # -- ring consumption ------------------------------------------------------

    def _next_windows_native(self):
        """Fast feed path: the native ring assembles the overlapping
        windows AND quantizes them (AGC gain + ADC saturation) in one
        pass — no Python carry, no float intermediates.  Returns
        (h int (B[, A], window, 2), metas, gain) or None."""
        cfg = self.cfg
        hop = cfg.window - cfg.overlap
        total = cfg.window + hop * (cfg.batch - 1)
        # every ring must hold the full span BEFORE any cursor moves, so
        # multi-antenna streams stay sample-aligned
        if any(r.available(vs) < total
               for r, vs in zip(self.rings, self.vss)):
            return None
        gain = self._agc_gain if cfg.agc else 1.0
        i8 = cfg.wire == "i8"
        sc = (I8_SCALE if i8 else I16_SCALE) * gain
        dt = np.int8 if i8 else np.int16
        reads = []
        try:
            for ring, vs in zip(self.rings, self.vss):
                reads.append(ring.read_windows(vs, cfg.window, hop,
                                               cfg.batch, sc, dt))
        except ValueError:          # span > ring capacity: fall back
            self._native_feed = False
            return None
        if any(r is None for r in reads):
            return None               # next call's alignment check mends
        starts = [s for _, s in reads]
        if len(set(starts)) > 1:
            # a producer overrun between the availability pre-check and a
            # later ring's read desynchronized the streams; metas/dedup
            # follow ring 0.  Drop the batch and realign every cursor to
            # the leading stream's position.
            self.stats.ring_resync += 1
            adv = hop * cfg.batch
            lead = max(starts) + adv
            for (_, s), ring, vs in zip(reads, self.rings, self.vss):
                gap = lead - (s + adv)
                while gap > 0:
                    got = ring.read(vs, min(gap, 1 << 16))
                    if len(got) == 0:     # rest not written yet: the
                        break             # next batch re-checks
                    gap -= len(got)
            return None
        arrs, start0 = [a for a, _ in reads], starts[0]
        h = np.stack(arrs, axis=1) if cfg.phy == "n" else arrs[0]
        metas = [start0 + i * hop for i in range(cfg.batch)]
        self._abs_off = start0 + hop * cfg.batch
        return h, metas, gain

    def _next_windows(self):
        """Assemble up to `batch` overlapping windows from the ring(s).
        Returns (x (B, window) or (B, A, window) complex64, metas) or None
        if not enough samples arrived yet."""
        cfg = self.cfg
        hop = cfg.window - cfg.overlap
        total = cfg.window + hop * (cfg.batch - 1)
        for a, (ring, vs) in enumerate(zip(self.rings, self.vss)):
            need = total - len(self._carry[a])
            if need > 0:
                got = ring.read(vs, need)
                if len(got):
                    self._carry[a] = np.concatenate([self._carry[a], got])
        avail = min(len(c) for c in self._carry)
        if avail < total:
            return None
        A = len(self.rings)
        x = np.empty((cfg.batch, A, cfg.window), np.complex64)
        metas = []
        for i in range(cfg.batch):
            s = i * hop
            for a in range(A):
                x[i, a] = self._carry[a][s: s + cfg.window]
            metas.append(self._abs_off + s)
        adv = hop * cfg.batch
        for a in range(A):
            self._carry[a] = self._carry[a][adv:]
        self._abs_off += adv
        if cfg.phy != "n":
            x = x[:, 0, :]
        return x, metas

    # -- TX data path (MAC11_Send, mac.cpp:293-345; send thread
    # mac.cpp:547-610; boot dot11main.cpp:229-257) -----------------------------

    def send(self, payload: bytes, dst: bytes,
             rate: float | None = None) -> None:
        """Queue a data frame for CSMA/CA transmission.  The waveform is
        pre-staged into the SignalCache immediately (the
        SoraURadioTransferEx step) so the eventual fire is a cache hit."""
        cfg = self.cfg
        hdr = MacHeader(addr1=bytes(dst), addr2=cfg.addr, addr3=cfg.addr,
                        seq_ctrl=self._tx_seq << 4)
        self._tx_seq = (self._tx_seq + 1) & 0xFFF
        self.send_frame(append_fcs(hdr.pack() + payload), bytes(dst),
                        rate)

    def send_frame(self, psdu: bytes, dst: bytes,
                   rate: float | None = None) -> None:
        """Queue a fully built PSDU (FCS included) — the path mgmt
        frames take (beacons, auth/assoc responses)."""
        cfg = self.cfg
        rate = rate if rate is not None else (cfg.data_rate
                                              if cfg.data_rate is not None
                                              else cfg.ack_rate)
        self.cache.get(psdu, rate)                      # pre-stage
        self._txq.append([psdu, bytes(dst), rate, 0])   # [.., retries]

    def start_join(self, bssid: bytes) -> None:
        """Client side of the reference's auth->assoc handshake
        (mgmt.cpp): queue an authentication request; the responses drive
        the rest of the exchange in _handle_mgmt."""
        self._join_target = bytes(bssid)
        self.send_frame(mgmt.build_auth(self.cfg.addr, self._join_target,
                                        seq_num=1), self._join_target)

    def _handle_mgmt(self, ftype: int, psdu: bytes) -> None:
        cfg = self.cfg
        self.stats.mgmt_rx += 1
        ap = bool(cfg.beacon_interval_s)
        if ftype == mgmt.FC_BEACON:
            bss = mgmt.parse_beacon(psdu)
            if bss is not None:
                self.bss_seen[bss.bssid] = bss
            return
        hdr = MacHeader.unpack(psdu[:24])
        if ftype == mgmt.FC_AUTH:
            parsed = mgmt.parse_auth(psdu)
            if parsed is None:
                return
            src, seq_num, status = parsed
            if ap and seq_num == 1:
                # authentication response (success): addr1 = the STA
                self.send_frame(mgmt.build_auth(cfg.addr, src,
                                                seq_num=2, status=0),
                                src)
            elif (seq_num == 2 and status == 0
                  and hdr.addr2 == self._join_target):
                bss = self.bss_seen.get(self._join_target) or mgmt.Bss(
                    bssid=self._join_target)
                self.send_frame(mgmt.build_assoc_req(cfg.addr, bss),
                                self._join_target)
            return
        if ftype == mgmt.FC_ASSOC_REQ and ap:
            aid = self.stations.setdefault(hdr.addr2,
                                           len(self.stations) + 1)
            bss = mgmt.Bss(ssid=cfg.ssid, bssid=cfg.addr)
            self.send_frame(mgmt.build_assoc_resp(hdr.addr2, bss, aid),
                            hdr.addr2)
            return
        if ftype == mgmt.FC_ASSOC_RESP:
            parsed = mgmt.parse_assoc_resp(psdu)
            if parsed is not None and hdr.addr2 == self._join_target:
                status, aid = parsed
                if status == 0:
                    self.associated_bssid = self._join_target

    def _beacon_step(self) -> None:
        """Queue a broadcast beacon every beacon_interval_s (the AP-mode
        beacon timer of the reference mgmt loop, mgmt.cpp /
        mac.cpp:547-610 send thread)."""
        cfg = self.cfg
        if not cfg.beacon_interval_s:
            return
        now = time.perf_counter()
        if now < self._next_beacon:
            return
        self._next_beacon = now + cfg.beacon_interval_s
        bss = mgmt.Bss(ssid=cfg.ssid, bssid=cfg.addr,
                       beacon_interval_tu=max(
                           1, int(cfg.beacon_interval_s * 1e6 / 1024)))
        psdu = mgmt.build_beacon(
            bss, timestamp_us=int(now * 1e6) & ((1 << 64) - 1),
            seq=self._tx_seq)
        self._tx_seq = (self._tx_seq + 1) & 0xFFF
        self.stats.beacons_tx += 1
        self.send_frame(psdu, b"\xff" * 6)

    def _ack_timeout_slots(self) -> int:
        cfg = self.cfg
        if cfg.ack_timeout_slots:
            return cfg.ack_timeout_slots
        # batched decode adds latency: the peer only sees our frame once
        # its batch window assembles, its detect gate fetches one batch
        # later, and its ACK crosses our own gate+decode pipeline —
        # budget three full batch spans plus margin
        hop = cfg.window - cfg.overlap
        total = cfg.window + hop * (cfg.batch - 1)
        return 64 + (3 * total) // self._slot

    def _enter_contend(self) -> None:
        self._tx_state = "contend"
        self._difs_left = DIFS_SLOTS
        self._backoff = int(self._tx_rng.integers(0, self._cw + 1))
        self._tx_clock = self._abs_off

    def _tx_fire(self) -> None:
        psdu, dst, rate, _ = self._txq[0]
        wave = self.cache.get(psdu, rate)               # pre-staged hit
        self.tx.fire(wave)
        self.stats.tx_data += 1
        if dst[0] & 1:        # group-addressed (broadcast/multicast):
            self._txq.popleft()                  # never ACKed (802.11
            self._cw = CW_MIN                    # group-address rule)
            self._tx_state = "idle"
            return
        self._tx_state = "wait_ack"
        self._ack_deadline = (self._abs_off + len(wave)
                              + self._ack_timeout_slots() * self._slot)

    def _tx_step(self) -> None:
        """Advance the TX FSM against the stream clock.  Carrier sense
        comes from the decode path: _dispatch extends _busy_until over
        every window whose detect metric fired."""
        now = self._abs_off
        if self._tx_state == "wait_ack":
            if now < self._ack_deadline:
                return
            pend = self._txq[0]
            pend[3] += 1
            self.stats.tx_retries += 1
            if pend[3] > RETRY_LIMIT:
                self._txq.popleft()
                self.stats.tx_drops += 1
                self._cw = CW_MIN
                self._tx_state = "idle"
            else:
                self._cw = min(2 * self._cw + 1, CW_MAX)   # BEB
                self._enter_contend()
            return
        if not self._txq:
            self._tx_state = "idle"
            return
        if self._tx_state == "idle":
            self._enter_contend()
            return
        # contend: consume idle slots between (_tx_clock, now); a busy
        # medium re-arms DIFS (mac.cpp:190-280 DIFS+backoff discipline)
        if self._tx_clock < self._busy_until:
            self._difs_left = DIFS_SLOTS
            self._tx_clock = min(now, self._busy_until)
        start = max(self._tx_clock, self._busy_until)
        avail = max(0, (now - start) // self._slot)
        used = 0
        while avail > 0 and (self._difs_left > 0 or self._backoff > 0):
            if self._difs_left > 0:
                self._difs_left -= 1
            else:
                self._backoff -= 1
            avail -= 1
            used += 1
        self._tx_clock = start + used * self._slot
        if self._difs_left == 0 and self._backoff == 0:
            self._tx_fire()

    # -- main loop -------------------------------------------------------------

    def skip_backlog(self) -> int:
        """Watchdog: when the consumer has fallen behind (ring backlog past
        the high-water mark), drop buffered samples and resume at the live
        edge — the reference's Seek(END_POS) backlog flush
        (rxstream.hpp:56-64, mac.cpp:247-249).  Returns samples dropped."""
        if not any(ring.available(vs) > self._backlog_hwm
                   for ring, vs in zip(self.rings, self.vss)):
            return 0
        # Advance every stream to the SAME absolute position.  carry[a][0]
        # sits at _abs_off for every a, so stream a can reach offset
        # len(carry[a]) + available(a); jump to the smallest common reach
        # minus half the high-water mark.
        reach = [len(c) + ring.available(vs) for c, ring, vs
                 in zip(self._carry, self.rings, self.vss)]
        target = min(reach) - self._backlog_hwm // 2
        if target <= max(len(c) for c in self._carry):
            return 0                       # cannot align-drop yet
        for a, (ring, vs) in enumerate(zip(self.rings, self.vss)):
            left = target - len(self._carry[a])
            while left > 0:
                left -= len(ring.read(vs, min(left, 1 << 18)))
            self._carry[a] = np.zeros(0, np.complex64)
        self._abs_off += target             # keep positions monotonic
        self.stats.backlog_dropped += target
        return target

    def step(self) -> bool:
        """One poll iteration: assemble a batch, issue its carrier-sense
        pass, CS-gate the *previous* batch (whose detect result has had a
        full batch of pipeline slack to arrive), issue its decode, retire
        the oldest in-flight decode.  Returns True if any work was done
        (the MAC11a_Receive loop body).

        Both the detect fetch and the decode fetch are double-buffered:
        the host never waits on a result that was issued less than one
        batch ago, and each wait is an event wait on that result's copies
        only (``util.xfer.Pending``)."""
        self.skip_backlog()
        self._beacon_step()
        t0 = time.perf_counter()
        gain = None
        if self._native_feed:
            nw = self._next_windows_native()
            if nw is not None:
                x, metas, gain = nw
        if gain is None and not self._native_feed:
            nw = self._next_windows()
            if nw is not None:
                x, metas = nw
        self._tx_step()
        if nw is None:
            self._gate(block=False)
            self._retire(block=False)
            return False
        if gain is not None:
            # native feed: windows arrive already quantized + gain-scaled
            nsamp = x.size // 2
            xd = device_quantized(x, self.device)
        else:
            gain = self._agc_gain if self.cfg.agc else 1.0
            to_dev = (device_complex8 if self.cfg.wire == "i8"
                      else device_complex16)
            nsamp = x.size
            xd = to_dev(x, self.device, scale=gain)
        self.stats.windows += self.cfg.batch
        det_f = Pending(self._detect(xd))     # (det, power), not waited for
        self._det_pend.append((xd, det_f, metas, t0, nsamp, gain))
        while len(self._det_pend) > 1:
            self._gate(block=True)
        while len(self._pend) > 1:
            self._retire(block=True)
        return True

    def _gate(self, block: bool) -> None:
        """Fetch the oldest pending carrier-sense result; if anything
        fired, issue that batch's decode (TCCA11a's no-energy early exit,
        cca.hpp:165-230 — idle air never pays the Viterbi)."""
        if not self._det_pend:
            return
        if not block and len(self._det_pend) < 2:
            # single in-flight detect: only consume it if the result has
            # already landed (never stall an idle poll on a fetch)
            if not self._det_pend[0][1].is_ready():
                return
        xd, det_f, metas, t0, nsamp, gain = self._det_pend.pop(0)
        det, power = det_f.get()
        fired = bool((det >= self.cfg.detect_threshold).any())
        if self.cfg.agc and fired:
            # peak window power in UNSCALED input units, tracked ONLY
            # while a carrier is detected: attack is instant (the max),
            # release halves the memory per carrier batch, and idle
            # noise can never crank the gain up
            p = float(np.max(power)) / (gain * gain)
            self._agc_peak = (p if self._agc_peak <= 0.0
                              else max(p, 0.5 * self._agc_peak))
            if self._agc_peak > 1e-12:
                self._agc_gain = float(np.clip(
                    self.cfg.agc_target / np.sqrt(self._agc_peak),
                    1.0 / 64.0, 256.0))
        if not fired:
            self.stats.cs_timeout += len(metas)
            self.sw.add(nsamp, time.perf_counter() - t0)
            return
        out = Pending(self._decode(xd))       # copies start behind it
        self._pend.append((out, metas, t0, nsamp, det))

    def flush(self) -> None:
        """Process the carry-buffer remnant (zero-padded to a full batch)
        and retire every in-flight batch — the MAC's Flush/Reset/Seek(END)
        quiesce (mac.cpp:237-249), where pinqueue pad() fills the last
        burst (pinqueue.h:133-145)."""
        cfg = self.cfg
        if self._native_feed:
            # the native feed keeps sub-batch remnants in the ring (no
            # carry); pull them out so the padded final batch sees them
            for a, (ring, vs) in enumerate(zip(self.rings, self.vss)):
                n = ring.available(vs)
                if n:
                    self._carry[a] = np.concatenate(
                        [self._carry[a], ring.read(vs, n)])
        if any(len(c) > 0 for c in self._carry):
            hop = cfg.window - cfg.overlap
            total = cfg.window + hop * (cfg.batch - 1)
            for a in range(len(self.rings)):
                pad = total - len(self._carry[a])
                if pad > 0:
                    self._carry[a] = np.concatenate(
                        [self._carry[a], np.zeros(pad, np.complex64)])
            native_saved, self._native_feed = self._native_feed, False
            try:
                self.step()
            finally:
                self._native_feed = native_saved
        while self._det_pend:
            self._gate(block=True)
        while self._pend:
            self._retire(block=True)

    def _retire(self, block: bool) -> None:
        if not self._pend:
            return
        if not block and len(self._pend) < 2:
            return
        out, metas, t0, nsamp, det = self._pend.pop(0)
        host = out.get()
        if isinstance(host, tuple) and host[0] == "n_both":
            # full HT auto: per-row winner between the 2-stream and the
            # 1-stream decode (exactly one closes its FCS for a real frame;
            # for idle rows the 2-stream fields stand)
            h2, h1 = host[1], host[2]
            use1 = (h1["ok"] == 1) & (h2["ok"] == 0)
            host = {}
            for k, a in h2.items():
                sel = use1.reshape(use1.shape + (1,) * (a.ndim - 1))
                host[k] = np.where(sel, h1[k], a)
        elif isinstance(host, tuple):            # b_known: a fixed 11b rate
            host = self._norm_b(host[1], host[2])
        self._dispatch(host, metas, det)
        self.sw.add(nsamp, time.perf_counter() - t0)
        self.stats.decoded_batches += 1
        self.stats.ring_drops = [r.drops(vs) for r, vs
                                 in zip(self.rings, self.vss)]

    # -- MAC dispatch ----------------------------------------------------------

    def _pos_scale(self) -> float:
        """Decoded-position units -> input-sample units (for dedup)."""
        if self.cfg.phy == "b":     # chip (11 Msps) -> input rate
            return {"11m": 1.0, "40m": 40.0 / 11.0, "44m": 4.0}[
                self.cfg.input_rate]
        return {"20m": 1.0, "40m": 2.0, "44m": 2.2}[self.cfg.input_rate]

    def _dispatch(self, out: dict, metas: list, det: np.ndarray) -> None:
        cfg = self.cfg
        sub = self._pos_scale()
        nrows = len(out["ok"])
        src = out.get("src")
        if src is not None:
            # compacted candidate rows: ``src`` maps each decode slot
            # back to its (window, onset) candidate
            K = cfg.max_frames_per_window
            win_of = np.asarray(src) // K
        else:
            K = max(1, nrows // max(1, len(metas)))  # cands per window
            win_of = np.arange(nrows) // K
        cs_ok = out.get("cs_ok")
        if cs_ok is None:
            cs_ok = np.repeat((det >= cfg.detect_threshold), K
                              ).astype(np.uint8)
        # window-level carrier accounting: any fired candidate marks the
        # medium busy through its window's end (window-granular CCA for
        # the TX FSM); a window with no fired candidate is idle air.
        # CCA must NOT depend on decode capacity: under compaction the
        # top-k may drop every candidate of a busy window, so the
        # PRE-compaction per-window detector also marks busy (the
        # reference's CCA defers regardless of what decodes,
        # mac.cpp:190-280) — and the dropped surplus is counted.
        det_w = np.asarray(det).reshape(-1)
        if len(det_w) == len(metas):
            fired = det_w >= cfg.detect_threshold
        else:
            fired = np.zeros(len(metas), bool)
        for i in range(nrows):
            if cs_ok[i]:
                fired[win_of[i]] = True
        n_cand = out.get("n_cand")
        if src is not None and n_cand is not None:
            drop = int(n_cand) - int((np.asarray(cs_ok) != 0).sum())
            if drop > 0:
                self.stats.compaction_drop += drop
        for w, f in enumerate(fired):
            if f:
                self._busy_until = max(self._busy_until,
                                       metas[w] + cfg.window)
            else:
                self.stats.cs_timeout += 1
        anchor = out.get("pos", out.get("lts1"))
        trunc = out.get("truncated")
        for i in range(nrows):
            if not out["ok"][i]:
                if cs_ok[i]:
                    if not out["sig_ok"][i]:
                        self.stats.plcp_fail += 1
                    elif trunc is not None and trunc[i]:
                        self.stats.truncated += 1
                    else:
                        self.stats.crc_fail += 1
                continue
            n = int(out["length"][i])
            psdu = bytes(out["psdu"][i][:n])
            # dedup across overlapping windows by absolute sample position
            pos = metas[win_of[i]] + int(int(anchor[i]) * sub)
            key = psdu[:24]          # header incl. seq_ctrl
            # a true duplicate (same frame seen through two overlapping
            # windows) lands at the SAME absolute stream position, up to
            # sync jitter; a looped replay of the same bytes lands much
            # further away and must count as a fresh frame
            old = self._seen.get(key)
            if old is not None and abs(old - pos) <= 64:
                self.stats.dup += 1
                continue
            self._seen[key] = pos
            self._seen_order.append(key)
            if len(self._seen_order) > 4096:
                self._seen.pop(self._seen_order.pop(0), None)
            if self.on_frame is not None:
                meta = {"psdu": psdu, "pos": pos}
                for k in ("rate_mbps", "mcs", "snr_db", "det", "cfo"):
                    if k in out:
                        meta[k] = float(out[k][i])
                self.on_frame(meta)
            self._handle_frame(psdu, t_decode=time.perf_counter())

    def _handle_frame(self, psdu: bytes, t_decode: float) -> None:
        cfg = self.cfg
        ftype = mgmt.frame_type(psdu)
        if ftype == mgmt.FC_ACK:
            self.stats.frame_ok += 1
            if (self._tx_state == "wait_ack" and self._txq
                    and len(psdu) >= 10 and psdu[4:10] == cfg.addr):
                self._txq.popleft()
                self._cw = CW_MIN
                self._tx_state = "idle"
                self.stats.tx_acked += 1
            return
        if len(psdu) < 28:
            self.stats.crc_fail += 1
            return
        hdr = MacHeader.unpack(psdu[:24])
        # group-addressed (broadcast/multicast) frames are for everyone
        # and are never ACKed; only exact-unicast frames get the ACK
        wants_us = hdr.addr1 == cfg.addr or bool(hdr.addr1[0] & 1)
        if not (wants_us or cfg.promiscuous):
            self.stats.not_for_us += 1
            return
        self.stats.frame_ok += 1
        if ftype != mgmt.FC_DATA:
            if wants_us and not cfg.promiscuous:
                self._handle_mgmt(ftype, psdu)
        else:
            self.rx_payloads.append((hdr.addr2, psdu[24:-4]))
            if self.on_payload is not None:
                self.on_payload(hdr.addr2, psdu[24:-4])
        if hdr.addr1 == cfg.addr and not cfg.promiscuous:
            ack = build_ack_frame(hdr.addr2)
            wave = self.cache.get(ack, cfg.ack_rate)       # pre-staged
            self.tx.fire(wave)
            self.stats.acks_tx += 1
            self.stats.ack_latency_s.append(
                time.perf_counter() - t_decode)

    # -- reporting -------------------------------------------------------------

    def report(self) -> str:
        return (self.stats.status_page() + "\n"
                + f"agc: gain {self._agc_gain:.4g} "
                + f"(peak power {self._agc_peak:.3g})\n"
                + "realtime: " + str(self.sw.report()))

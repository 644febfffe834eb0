"""The port's promiscuous sniffer (``sora_tpu_torch.apps.sniffer``) against
``sora_tpu.apps.sniffer`` on the CPU: the scenario of tests/test_sniffer.py
(a beacon and two data frames to different destinations) through both
sniffers, run on a pass clock (step until idle), with the same frames,
histogram and console table, pcaps that each package reads back, and
``format_frame`` equal line for line."""

import io
from pathlib import Path

import numpy as np
import pytest
import torch

from sora_tpu.apps import sniffer as jsn
from sora_tpu.golden import dot11a_np as g
from sora_tpu.mac import mgmt
from sora_tpu.mac.frame import MacHeader, append_fcs
from sora_tpu.runtime.native import RxRing as JRing
from sora_tpu.runtime.node import NodeConfig as JCfg
from sora_tpu_torch.apps import sniffer as tsn
from sora_tpu_torch.runtime.native import RxRing as TRing
from sora_tpu_torch.runtime.node import NodeConfig as TCfg

torch.set_num_threads(2)

CAPTURE = str(Path(__file__).resolve().parent / "data" / "fsample54.dmp")
A = b"\x02NODEA"
B = b"\x02NODEB"
CFG = dict(window=4096, batch=2, overlap=2816, max_psdu=256,
           min_rate_mbps=24)


def _air(rng):
    """Beacon + two data frames to different destinations + noise gaps
    (tests/test_sniffer.py:20-36)."""
    bss = mgmt.Bss(bssid=A, ssid="net", rates_mbps=(6, 12))
    frames = [mgmt.build_beacon(bss, timestamp_us=1234),
              append_fcs(MacHeader(addr1=B, addr2=A, addr3=A,
                                   seq_ctrl=1 << 4).pack() + b"x" * 60),
              append_fcs(MacHeader(addr1=A, addr2=B, addr3=B,
                                   seq_ctrl=2 << 4).pack() + b"y" * 60)]
    pieces = []
    for f in frames:
        pieces.append(np.zeros(700, np.complex64))
        pieces.append(g.modulate(f, 12).astype(np.complex64))
    pieces.append(np.zeros(2100, np.complex64))
    x = np.concatenate(pieces)
    x += (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x))
          ).astype(np.complex64) * 0.01
    return x, frames


def _run(sniffer):
    """Step until three passes in a row find nothing to do."""
    idle = 0
    while idle < 3:
        idle = 0 if sniffer.node.step() else idle + 1
    sniffer.node.flush()


def _capture(sniffer_cls, ring_cls, cfg, x, pcap, **kw):
    ring = ring_cls(capacity=1 << 20)
    out = io.StringIO()
    sn = sniffer_cls(ring, cfg, pcap_path=pcap, out=out, **kw)
    ring.write(x)
    _run(sn)
    sn.close()
    ring.close()
    return sn, [l for l in out.getvalue().splitlines() if l.strip()]


def test_sniffer_matches_jax(rng, tmp_path):
    x, frames = _air(rng)
    tp, jp = str(tmp_path / "torch.pcap"), str(tmp_path / "jax.pcap")
    got, glines = _capture(tsn.Sniffer, TRing, TCfg(**CFG), x, tp,
                           device="cpu")
    want, wlines = _capture(jsn.Sniffer, JRing, JCfg(**CFG), x, jp)
    # promiscuous: all 3 frames regardless of addr1
    assert sum(got.hist.values()) == 3, got.summary()
    assert got.hist["beacon"] == 1 and got.hist["data"] == 2
    assert dict(got.hist) == dict(want.hist)
    assert [m["psdu"] for m in got.frames] == frames
    assert [m["psdu"] for m in got.frames] == [m["psdu"] for m in
                                               want.frames]
    for gm, wm in zip(got.frames, want.frames):
        assert gm["pos"] == wm["pos"] and gm["rate_mbps"] == wm["rate_mbps"]
    assert len(glines) == len(wlines) == 3
    assert any("beacon" in l for l in glines)
    assert any("02:4e:4f:44:45:42" in l for l in glines)   # B as dest
    # the table equals JAX's but for the SNR column (float estimates)
    cut = lambda l: l.rsplit(" snr=", 1)[0]
    assert [cut(l) for l in glines] == [cut(l) for l in wlines]
    # each pcap reads back byte-identical frames in capture order, through
    # either package's reader
    for path in (tp, jp):
        for reader in (tsn.read_pcap, jsn.read_pcap):
            assert [f for _, f in reader(path)] == frames
    assert got.pcap.n == 3


def test_format_frame_equals_jax():
    metas = [{"psdu": bytes.fromhex("d4000000") + A + b"\x00" * 4,
              "pos": 20000, "rate_mbps": 6.0, "snr_db": 23.0},
             {"psdu": MacHeader(addr1=B, addr2=A, addr3=A,
                                seq_ctrl=9 << 4).pack() + b"z" * 8,
              "pos": 123457, "rate_mbps": 54.0, "snr_db": 31.25},
             {"psdu": b"\x08", "pos": 5}]
    for m in metas:
        assert tsn.format_frame(m, 20e6) == jsn.format_frame(m, 20e6)
    line = tsn.format_frame(metas[0], 20e6)
    assert "ack" in line and "02:4e:4f:44:45:41" in line
    assert "1.000ms" in line


def test_pcap_writer_equals_jax(tmp_path):
    recs = [(b"\x08\x00" + b"a" * 30, 1.5), (b"\xd4\x00" + b"b" * 12, 2.25)]
    paths = []
    for mod in (tsn, jsn):
        path = tmp_path / f"{mod.__name__}.pcap"
        w = mod.PcapWriter(str(path))
        for psdu, ts in recs:
            w.write(psdu, ts)
        w.close()
        paths.append(path.read_bytes())
    assert paths[0] == paths[1]
    with pytest.raises(ValueError, match="not an 802.11 classic pcap"):
        bad = tmp_path / "bad.pcap"
        bad.write_bytes(b"\x00" * 24)
        tsn.read_pcap(str(bad))


def test_cli_synthetic_to_pcap(tmp_path, capsys):
    """The CLI's synthetic config is the JAX CLI's, overlap warning
    included (a 256-byte 6 Mbps frame spans more than its overlap)."""
    pcap = str(tmp_path / "cli.pcap")
    with pytest.warns(UserWarning, match="overlap 5120 < max frame span"):
        rc = tsn.main(["--synthetic", "4", "--rate", "24", "--pcap", pcap,
                       "--seconds", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    recs = tsn.read_pcap(pcap)
    assert len(recs) > 0
    assert f"pcap: {len(recs)} frames" in out


def test_cli_dump_replays_the_54_mbps_capture(capsys):
    """--dump on the 40 Msps 54 Mbps capture decodes.  The dump holds ADC
    counts; the JAX app replays them raw, and at the AGC's gain floor
    (1/64) the int16 wire (2048 per unit) still clips them, so its 64-QAM
    frames fail the CRC there.  The port replays counts / 2048."""
    from sora_tpu_torch.runtime.native import parse_dump
    from sora_tpu_torch.util.xfer import I16_SCALE

    counts = parse_dump(CAPTURE)
    assert np.abs(counts).max() / 64.0 * I16_SCALE > 32767
    assert np.abs(counts / I16_SCALE).max() * I16_SCALE <= 32767
    with pytest.warns(UserWarning, match="overlap"):
        rc = tsn.main(["--dump", CAPTURE, "--seconds", "3", "--device",
                       "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "len=1500 54.0M" in out

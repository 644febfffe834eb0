"""The port's tooling against the JAX package's on the same seeded inputs:
hwveri (within 1e-9), render (identical strings), trace files (the same
bytes, read back across the two packages, ring wrap, live attach),
speanalyzer's ``welch_spectrum`` (within 1e-3 dB) and CLI, the plotview
and srview viewers, and usereg with the radio state file (the same bytes
as the JAX package's ``save_state``)."""

import numpy as np
import pytest
import torch

from sora_tpu.apps import speanalyzer as jspe
from sora_tpu.apps import srview as jsrv
from sora_tpu.apps import usereg as jusr
from sora_tpu.runtime import radio as jradio
from sora_tpu.util import hwveri as jhw
from sora_tpu.util import render as jrender
from sora_tpu.util import trace as jtrace
from sora_tpu_torch.apps import plotview as tplot
from sora_tpu_torch.apps import speanalyzer as tspe
from sora_tpu_torch.apps import srview as tsrv
from sora_tpu_torch.apps import usereg as tusr
from sora_tpu_torch.runtime import radio as tradio
from sora_tpu_torch.util import hwveri as thw
from sora_tpu_torch.util import render as trender
from sora_tpu_torch.util import trace as ttrace

torch.set_num_threads(2)

CAPTURE = "tests/data/fsample54.dmp"
HW_ATOL = 1e-9            # hwveri: the same numpy code in float64
WELCH_DB_ATOL = 1e-3      # float32 FFTs of two libraries, in dB


def _tone(fs, f, n, amp=0.5, snr_db=None, seed=0, dc=0.0):
    rng = np.random.default_rng(seed)
    x = amp * np.exp(2j * np.pi * f / fs * np.arange(n)) + dc
    if snr_db is not None:
        s = amp / np.sqrt(2 * 10 ** (snr_db / 10))
        x = x + s * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return x.astype(np.complex64)


TONES = [dict(fs=20e6, f=1.25e6, n=4096, snr_db=30),
         dict(fs=40e6, f=-7.3e6, n=8192, snr_db=12, seed=3, dc=0.05),
         dict(fs=20e6, f=3e3, n=2048, amp=0.01, seed=5, snr_db=40),
         dict(fs=11e6, f=2.2e6, n=1000, amp=0.9)]


@pytest.mark.parametrize("tone", TONES)
def test_hwveri_equals_jax(tone):
    x = _tone(**tone)
    fs = tone["fs"]
    a, b = thw.sine_wave_test(x, fs), jhw.sine_wave_test(x, fs)
    for key in ("freq_hz", "amplitude", "spur_db", "thd_db"):
        assert abs(getattr(a, key) - getattr(b, key)) <= HW_ATOL * max(
            1.0, abs(getattr(b, key))), key
    assert abs(a.dc - b.dc) <= HW_ATOL and a.ok == b.ok
    assert abs(thw.snr_test(x, fs) - jhw.snr_test(x, fs)) <= HW_ATOL
    for f_exp in (tone["f"], tone["f"] + 1e3):
        assert abs(thw.measure_freq_offset(x, fs, f_exp)
                   - jhw.measure_freq_offset(x, fs, f_exp)) <= HW_ATOL
    for target in (0.25, 0.05):
        ga = thw.agc_select_gain(x, target_rms=target)
        gj = jhw.agc_select_gain(x, target_rms=target)
        assert (ga.gain, ga.clipped) == (gj.gain, gj.clipped)
        assert abs(ga.rms_in - gj.rms_in) <= HW_ATOL
        assert abs(ga.rms_out - gj.rms_out) <= HW_ATOL


def test_hwveri_measures_a_tone():
    """tests/test_tooling.py's expectations, held by the port."""
    x = _tone(20e6, 1.25e6, 8192, snr_db=40, dc=0.1)
    rep = thw.sine_wave_test(x, 20e6)
    assert rep.ok and abs(rep.freq_hz - 1.25e6) < 1.25e3
    assert abs(rep.dc - 0.1) < 0.01 and abs(rep.amplitude - 0.5) < 0.05
    assert 20 < thw.snr_test(_tone(20e6, 3e6, 16384, snr_db=25), 20e6) < 30
    x = _tone(20e6, 2e6 + 3125.0, 65536, snr_db=35)
    assert abs(thw.measure_freq_offset(x, 20e6, 2e6) - 3125.0) < 20.0
    r = thw.agc_select_gain(_tone(20e6, 1e6, 4096, amp=0.01, snr_db=30))
    assert r.gain >= 16 and not r.clipped
    assert thw.agc_select_gain(_tone(20e6, 1e6, 4096, amp=0.9)).gain == 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_equals_jax(seed):
    rng = np.random.default_rng(seed)
    v = np.cumsum(rng.normal(size=300))
    for kw in ({}, {"width": 40}, {"width": 500, "lo": -3.0, "hi": 3.0}):
        assert trender.sparkline(v, **kw) == jrender.sparkline(v, **kw)
    for kw in ({}, {"width": 40, "height": 6, "label": "x"},
               {"lo": 0.0, "hi": 1.0}):
        assert trender.chart(v, **kw) == jrender.chart(v, **kw)
    pts = (rng.choice([-1, 1], 256) + 1j * rng.choice([-1, 1], 256)
           + 0.1 * (rng.normal(size=256) + 1j * rng.normal(size=256)))
    for kw in ({}, {"width": 24, "height": 12}, {"span": 2.0}):
        assert trender.constellation(pts, **kw) == \
            jrender.constellation(pts, **kw)
    assert trender.constellation(np.zeros(4)) == "(no points)"


CHANNELS = {"snr": ("line", 4, 8), "const": ("dots", 6, 4),
            "spec": ("spectrum", 16, 2), "mac": ("text", 0, 4)}


def _write(mod, path):
    w = mod.TraceWriter(path, CHANNELS)
    for i in range(11):                   # "snr" wraps its 8 slots
        w.plot_line("snr", [i, i + 1, i + 2, i + 3])
    w.plot_dots("const", np.arange(6) * (1 + 1j))
    w.plot_spectrum("spec", np.linspace(-90, 0, 16))
    w.log("mac", "frame ok rate=54")
    w.plot_text("mac", "x" * 200)        # clipped to the 120-byte record
    w.close()


@pytest.mark.parametrize("writer,reader", [(jtrace, ttrace), (ttrace, jtrace),
                                           (ttrace, ttrace)])
def test_trace_files_cross_read(tmp_path, writer, reader):
    p = str(tmp_path / "t.dbg")
    _write(writer, p)
    r = reader.TraceReader(p)
    snr = r.read("snr")
    assert snr.shape == (8, 4)
    assert snr[:, 0].tolist() == [float(i) for i in range(3, 11)]
    dots = r.read("const")
    assert dots.dtype == np.complex64 and dots[0, 5] == 5 + 5j
    assert r.read("spec").shape == (1, 16)
    assert r.read("mac") == ["frame ok rate=54", "x" * 120]
    assert r.kind("const") == "dots" and r.kind("mac") == "text"
    r.close()


def test_trace_file_bytes_equal_jax(tmp_path):
    a, b = str(tmp_path / "t.dbg"), str(tmp_path / "j.dbg")
    _write(ttrace, a)
    _write(jtrace, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_trace_live_attach(tmp_path):
    """A reader attached before later writes still sees them (the
    out-of-process viewer pattern), across the two packages."""
    p = str(tmp_path / "t.dbg")
    w = ttrace.TraceWriter(p, {"v": ("line", 1, 8)})
    w.plot_line("v", [1.0])
    r, rj = ttrace.TraceReader(p), jtrace.TraceReader(p)
    assert r.read("v").shape == rj.read("v").shape == (1, 1)
    w.plot_line("v", [2.0])
    assert r.read("v")[:, 0].tolist() == rj.read("v")[:, 0].tolist() == [
        1.0, 2.0]
    w.close(); r.close(); rj.close()


def test_trace_rejects_other_files(tmp_path):
    p = tmp_path / "junk"
    p.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="not a sora_tpu trace file"):
        ttrace.TraceReader(str(p))


def _capture():
    from sora_tpu_torch.io.dumpfile import load_dump
    x = load_dump(CAPTURE)
    return x - x.mean()


@pytest.mark.parametrize("src,nfft,fs", [("tone", 1024, 20e6),
                                         ("tone", 256, 40e6),
                                         ("capture", 1024, 40e6),
                                         ("capture", 512, 40e6)])
def test_welch_spectrum_equals_jax(src, nfft, fs):
    if src == "tone":
        x = _tone(fs, 3.2e6, 65536, amp=1.0, snr_db=40, seed=nfft)
    else:
        x = _capture()
    f_t, p_t = tspe.welch_spectrum(x, nfft, fs, device="cpu")
    f_j, p_j = jspe.welch_spectrum(x, nfft, fs)
    assert np.array_equal(f_t, f_j)
    assert p_t.shape == (nfft,) and np.isfinite(p_t).all()
    assert np.abs(p_t - p_j).max() < WELCH_DB_ATOL
    assert int(np.argmax(p_t)) == int(np.argmax(p_j))
    with pytest.raises(ValueError, match="need at least"):
        tspe.welch_spectrum(x[: nfft - 1], nfft, fs, device="cpu")


def test_speanalyzer_cli_tone_and_trace(tmp_path, capsys):
    """--tone through the port's CLI prints the JAX CLI's chart and peak
    line, and its trace renders in the port's plotview."""
    path = str(tmp_path / "t.trace")
    args = ["--tone", "3.2e6", "--msps", "20", "--trace", path]
    assert tspe.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert jspe.main(["--tone", "3.2e6", "--msps", "20"]) == 0
    want = capsys.readouterr().out
    assert "peak" in out and "@ +3.203 MHz" in out
    assert out.splitlines()[:-1] == want.splitlines()
    assert "spectrum written" in out
    assert tplot.main([path]) == 0
    text = capsys.readouterr().out
    assert "== spectrum [spectrum] ==" in text and "record 0" in text


def test_speanalyzer_cli_dump(capsys):
    assert tspe.main(["--dump", CAPTURE, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert jspe.main(["--dump", CAPTURE]) == 0
    assert out == capsys.readouterr().out


def test_plotview_renders_every_kind(tmp_path, capsys):
    path = str(tmp_path / "v.trace")
    tw = ttrace.TraceWriter(path, {"snr": ("line", 64, 16),
                                   "const": ("dots", 48, 8),
                                   "mac": ("text", 0, 8),
                                   "idle": ("line", 8, 2)})
    for k in range(3):
        tw.plot_line("snr", np.linspace(0, 20 + k, 64))
    tw.plot_dots("const", np.asarray([1 + 1j, -1 - 1j] * 24, np.complex64))
    tw.log("mac", "frame_ok len=1392")
    tw.close()
    assert tplot.main([path]) == 0
    out = capsys.readouterr().out
    from sora_tpu.apps import plotview as jplot
    assert jplot.main([path]) == 0
    assert out == capsys.readouterr().out
    assert "== snr [line] ==" in out and "prev:" in out
    assert "frame_ok len=1392" in out and "(empty)" in out
    assert tplot.main([path, "--channel", "nope"]) == 2


def test_srview_equals_jax(tmp_path, capsys):
    """info, cut and ascii on the checkout's capture print what the JAX
    viewer prints, and the cut files are the same bytes."""
    for cmd in (["info", CAPTURE], ["ascii", CAPTURE, "--bins", "40"]):
        assert tsrv.main(cmd) == 0
        out = capsys.readouterr().out
        assert jsrv.main(cmd) == 0
        assert out == capsys.readouterr().out
    a, b = str(tmp_path / "a.dmp"), str(tmp_path / "b.dmp")
    assert tsrv.main(["cut", CAPTURE, a, "1000", "5001"]) == 0
    assert jsrv.main(["cut", CAPTURE, b, "1000", "5001"]) == 0
    assert tsrv.main(["info", a]) == 0
    assert "4004 samples" in capsys.readouterr().out
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_srview_info_reports_the_capture(capsys):
    assert tsrv.main(["info", CAPTURE]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == f"{CAPTURE}: 10584 samples"
    assert "active region" in out


USEREG_SCRIPT = [["wr", "0x20", "0xBEEF"], ["set", "rxgain", "7.5"],
                 ["wr", "3", "17"], ["set", "freq", "2.412e9"],
                 ["set", "rate", "40e6"], ["wr", "0x20", "0x1"]]


def test_usereg_state_file_equals_jax(tmp_path, capsys):
    """The same commands through both CLIs leave the same bytes, and each
    package reads the other's file."""
    st_t, st_j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    for cmd in USEREG_SCRIPT:
        assert tusr.main(["--state", st_t] + cmd) == 0
        assert jusr.main(["--state", st_j] + cmd) == 0
    with open(st_t, "rb") as ft, open(st_j, "rb") as fj:
        assert ft.read() == fj.read()
    assert vars(tradio.load_state(st_j)) == vars(jradio.load_state(st_t))
    for cmd in (["rr", "0x20"], ["rr", "0x99"], ["get", "rxgain"],
                ["get", "rate"], ["dump"]):
        assert tusr.main(["--state", st_t] + cmd) == 0
        out = capsys.readouterr().out
        assert jusr.main(["--state", st_j] + cmd) == 0
        assert out == capsys.readouterr().out


def test_usereg_roundtrip(tmp_path, capsys, monkeypatch):
    st = str(tmp_path / "radio.json")
    monkeypatch.setenv("SORA_RADIO_STATE", st)
    assert tusr.main(["wr", "0x20", "0xBEEF"]) == 0
    assert tusr.main(["rr", "0x20"]) == 0
    assert capsys.readouterr().out.strip() == "0x0000BEEF"
    assert tusr.main(["set", "rxgain", "7.5"]) == 0
    assert tusr.main(["get", "rxgain"]) == 0
    assert capsys.readouterr().out.strip() == "7.5"
    state = tradio.load_state(st)
    assert state.registers[0x20] == 0xBEEF and state.rx_gain_db == 7.5


def test_save_state_equals_jax(tmp_path):
    st = tradio.RadioState(central_freq_hz=5.18e9, rx_gain_db=-3.5,
                           running=True, registers={7: 1, 0x100: 0xFFFF})
    sj = jradio.RadioState(**{k: v for k, v in vars(st).items()})
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    tradio.save_state(st, a)
    jradio.save_state(sj, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert tradio.load_state(b) == st


def _reference_ping_tool():
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "reference_ping_over_air", root / "tools" / "ping_over_air.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ping_over_air_skips_without_root(monkeypatch, capsys):
    from sora_tpu_torch.tools import ping_over_air as tping

    ref = _reference_ping_tool()
    monkeypatch.setattr("os.geteuid", lambda: 1000)
    assert tping.main([]) == 2
    out = capsys.readouterr().out
    assert ref.main() == 2
    skip = "SKIP: needs root + /dev/net/tun\n"
    assert out == capsys.readouterr().out == skip
    # root and the TUN device, but no iproute2 for the namespaces
    monkeypatch.setattr("os.geteuid", lambda: 0)
    monkeypatch.setattr("os.path.exists", lambda p: True)
    monkeypatch.setattr("shutil.which", lambda name: None)
    assert tping.main([]) == 2
    assert capsys.readouterr().out == "SKIP: needs the ip command (iproute2)\n"


class _Built(Exception):
    pass


def test_ping_over_air_node_config_equals_jax(monkeypatch):
    """The port's nodes take the reference tool's NodeConfig (captured where
    the JAX tool builds its first node, before any TAP or netns exists)."""
    import os

    import sora_tpu.runtime.node as jnode
    import sora_tpu.util.platform as jplat
    from sora_tpu_torch.tools import ping_over_air as tping

    ref = _reference_ping_tool()
    built = []

    def capture(ring, cfg, **kw):
        built.append(cfg)
        raise _Built

    monkeypatch.setattr(os, "geteuid", lambda: 0)
    monkeypatch.setattr(os.path, "exists", lambda p: True)
    monkeypatch.setattr(jplat, "setup_jax", lambda: None)
    monkeypatch.setattr(jnode, "StreamingNode", capture)
    with pytest.raises(_Built):
        ref.main()
    want = vars(built[0])
    got = vars(tping.node_config(ref.ADDR_A))
    assert got == want and got["addr"] == tping.ADDR_A == ref.ADDR_A
    assert (got["window"], got["overlap"]) == (32768, 11264)
    assert (tping.ADDR_B, tping.NS_A, tping.NS_B) == (ref.ADDR_B, ref.NS_A,
                                                      ref.NS_B)

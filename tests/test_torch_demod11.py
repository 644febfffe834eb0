"""The port's offline mod/demod harness (``sora_tpu_torch.apps.demod11``)
on the CPU: the CLI round trip of tests/test_tooling.py:189-204 (mod ->
dump -> demod through the golden and the torch chains, then ack), the
raw 40 Msps device front-end path on tests/data/fsample54.dmp, the 11b and
11n round trips, and dumps written bit for bit as the JAX harness writes
them.  ``--device cpu`` stands in for the card."""

from pathlib import Path

import numpy as np
import pytest
import torch

from sora_tpu.apps import demod11 as jdemod
from sora_tpu_torch.apps import demod11 as tdemod
from sora_tpu_torch.io import dumpfile as tdump

torch.set_num_threads(2)

CPU = ("--device", "cpu")
CAPTURE = str(Path(__file__).resolve().parent / "data" / "fsample54.dmp")


def test_demod11_cli_roundtrip(tmp_path, capsys):
    out = str(tmp_path / "w.dmp")
    assert tdemod.main(["--std", "11a", "--mode", "mod", "--rate", "12",
                        "--payload", "cli roundtrip", "--outfile", out]) == 0
    assert tdemod.main(["--std", "11a", "--mode", "demod", "--chain",
                        "golden", "--infile", out, "--msps", "20"]) == 0
    assert tdemod.main(["--std", "11a", "--mode", "demod", "--chain",
                        "torch", "--infile", out, "--msps", "20", *CPU]) == 0
    text = capsys.readouterr().out
    assert text.count("frame_ok") >= 2
    assert text.count("frame: frame_ok rate=12 len=41 fcs_ok=True") == 2
    assert tdemod.main(["--mode", "ack", "--rate", "24", *CPU]) == 0
    assert "MATCH" in capsys.readouterr().out


def test_demod11_raw40_device_frontend(capsys):
    """The raw 40 Msps capture straight into the torch chain (DC removal
    and decimation on the device), and through the host front end."""
    cap = CAPTURE
    assert tdemod.main(["--std", "11a", "--mode", "demod", "--chain",
                        "torch", "--infile", cap, "--msps", "40", *CPU]) == 0
    assert tdemod.main(["--std", "11a", "--mode", "demod", "--chain",
                        "torch", "--infile", cap, "--msps", "40",
                        "--host-frontend", *CPU]) == 0
    text = capsys.readouterr().out
    assert text.count("frame: frame_ok rate=54 len=1500 fcs_ok=True") == 2
    # the default input is the same capture
    assert tdemod.main(["--mode", "demod", "--chain", "torch", *CPU]) == 0


@pytest.mark.parametrize("std,rate", [("11a", "54"), ("11b", "11"),
                                      ("11b", "2"), ("11n", "15")])
def test_mod_dumps_equal_jax_and_round_trip(tmp_path, capsys, std, rate):
    args = ["--std", std, "--mode", "mod", "--rate", rate, "--payload",
            f"{std} harness"]
    tout, jout = str(tmp_path / "t.dmp"), str(tmp_path / "j.dmp")
    assert tdemod.main(args + ["--outfile", tout]) == 0
    assert jdemod.main(args + ["--outfile", jout]) == 0
    files = [".s0", ".s1"] if std == "11n" else [""]
    for suffix in files:
        with open(tout + suffix, "rb") as a, open(jout + suffix, "rb") as b:
            assert a.read() == b.read()
    infiles = [a for s in files for a in ("--infile", tout + s)]
    demod = ["--std", std, "--mode", "demod", "--msps", "20", *infiles]
    capsys.readouterr()
    assert tdemod.main(demod + ["--chain", "torch", *CPU]) == 0
    assert "frame: frame_ok " in capsys.readouterr().out
    if std == "11n":
        # the golden 11n sync misses a frame 64 samples into the dump, in
        # the JAX harness too (a reference quirk, kept)
        assert tdemod.main(demod + ["--chain", "golden"]) == \
            jdemod.main(demod + ["--chain", "golden"]) == 1
    else:
        assert tdemod.main(demod + ["--chain", "golden"]) == 0
        assert "frame: frame_ok " in capsys.readouterr().out


def test_jax_harness_raises_on_11b_demod(tmp_path):
    """A reference fault the port does not copy: the JAX harness prints
    ``res.length``, which the 11b result lacks."""
    out = str(tmp_path / "b.dmp")
    assert jdemod.main(["--std", "11b", "--mode", "mod", "--rate", "11",
                        "--outfile", out]) == 0
    with pytest.raises(AttributeError, match="length"):
        jdemod.main(["--std", "11b", "--mode", "demod", "--infile", out,
                     "--msps", "20"])


def test_save_dump_round_trips(tmp_path):
    x = (np.arange(60) - 30) * (1 + 2j) * 100.0
    assert tdump.save_dump(str(tmp_path / "x.dmp"), x, bits=14) == 84
    back = tdump.load_dump(str(tmp_path / "x.dmp"))
    np.testing.assert_array_equal(back[:60], x.astype(np.complex64))
    assert not back[60:].any()
    # 14-bit saturation, not wrap-around
    tdump.save_dump(str(tmp_path / "y.dmp"), np.array([1e6 + 0j]), bits=14)
    assert tdump.load_dump(str(tmp_path / "y.dmp"))[0] == 8191

"""``sora_tpu_torch.tools.ping_over_air`` end to end on the CPU: two port
nodes, cross-wired and bridged to TAPs in two network namespaces, carry a
kernel UDP echo over the software air (ARP both ways, then the datagram and
its echo as 802.11a frames through the CSMA/CA MAC).

It needs root, ``/dev/net/tun`` and iproute2's ``ip``; the tool runs in a
process of its own, with two intra-op threads, under its own timeout.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TOOL_TIMEOUT_S = 420      # warm-up + the tool's own 180 s air loop, twice over


@pytest.mark.netns
@pytest.mark.skipif(
    not (os.geteuid() == 0 and os.path.exists("/dev/net/tun")
         and shutil.which("ip")),
    reason="needs root, /dev/net/tun and the ip command (iproute2)")
def test_ping_over_air_udp_echo_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run(
        [sys.executable, "-m", "sora_tpu_torch.tools.ping_over_air",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=TOOL_TIMEOUT_S)
    out = p.stdout + p.stderr
    assert p.returncode == 0, out
    assert "client got b'echo:ping-over-the-air'" in p.stdout, out
    assert "udp-echo-over-air OK" in p.stdout, out

"""usereg: read/write the radio register image and front-end knobs from
the command line — the analogue of the reference's usereg tool
(usr/usereg/usereg/usereg.cpp: DeviceIoControl register peek/poke into
the RCB) over the SoftRadio's persisted RADIO_CONTEXT (port of
``sora_tpu.apps.usereg``; numpy only).

The image lives in a JSON file (``--state``, default $SORA_RADIO_STATE
or sora-radio0.json in the temporary directory); the process owning the
radio reloads it to apply changes live.  The file is the JAX package's
byte for byte.

Usage (``python -m sora_tpu_torch.apps.usereg ...``):
  rr <addr>                 read a register
  wr <addr> <value>         write a register
  get <knob>                rxgain|txgain|rxpa|freq|offset|rate
  set <knob> <value>
  dump                      print the whole register image
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from sora_tpu_torch.runtime.radio import RadioState, load_state, save_state

KNOBS = {
    "rxgain": "rx_gain_db",
    "txgain": "tx_gain_db",
    "rxpa": "rx_pa_db",
    "freq": "central_freq_hz",
    "offset": "freq_offset_hz",
    "rate": "sample_rate_sps",
}


def _load(path: str) -> RadioState:
    if os.path.exists(path):
        return load_state(path)
    return RadioState()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sora_tpu_torch.apps.usereg",
                                description=__doc__.split("\n")[0])
    p.add_argument("--state", default=os.environ.get(
        "SORA_RADIO_STATE",
        os.path.join(tempfile.gettempdir(), "sora-radio0.json")))
    sub = p.add_subparsers(dest="cmd", required=True)
    rr = sub.add_parser("rr")
    rr.add_argument("addr", type=lambda s: int(s, 0))
    wr = sub.add_parser("wr")
    wr.add_argument("addr", type=lambda s: int(s, 0))
    wr.add_argument("value", type=lambda s: int(s, 0))
    gt = sub.add_parser("get")
    gt.add_argument("knob", choices=sorted(KNOBS))
    st = sub.add_parser("set")
    st.add_argument("knob", choices=sorted(KNOBS))
    st.add_argument("value", type=float)
    sub.add_parser("dump")
    args = p.parse_args(argv)

    state = _load(args.state)
    if args.cmd == "rr":
        print(f"0x{state.registers.get(args.addr, 0):08X}")
    elif args.cmd == "wr":
        state.registers[args.addr] = args.value
        save_state(state, args.state)
    elif args.cmd == "get":
        print(getattr(state, KNOBS[args.knob]))
    elif args.cmd == "set":
        setattr(state, KNOBS[args.knob], float(args.value))
        save_state(state, args.state)
    elif args.cmd == "dump":
        for k, v in sorted(vars(state).items()):
            print(f"{k:18s} {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

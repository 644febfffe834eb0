"""Where the Viterbi kernel's time goes, on one CUDA card.

    python3 -m sora_tpu_torch.tools.viterbi_probe [--compare OTHER.cu ...]
                                                  [--sass DIR]

Builds ``csrc/viterbi.cu`` and variants of it with one part cut out
(the traceback walks, the renorm's warp reduction, the soft-value loads,
the butterfly shuffles; their outputs are wrong, only their times count),
and times each with CUDA events at the 54 Mbps bench shape (128 streams of
T = 12096, block 1024, overlap 64), in two rounds of alternating turns.
What a cut saves bounds what making that part faster can give.  Then it
times the kernel across batch sizes: a time that barely grows with the
number of windows says the kernel is bound by each window's dependent
chain, not by the card's issue rate.  ``--compare`` times other versions
of the source in the same turns (for instance the parent commit's);
``--sass`` writes each library's SASS there.  It needs CUDA and nvcc and
exits nonzero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from sora_tpu_torch.dsp import viterbi as dvit
from sora_tpu_torch.ops import viterbi_cuda as vc

B, T, BLOCK, OVERLAP = 128, 12096, 1024, 64
SWEEP = (8, 32, 64, 128, 256)

# name -> [(text of csrc/viterbi.cu, its replacement)], each text once
CUTS = {
    "no traceback walks": [("  if (lane < 3) {", "  if (false) {")],
    "no renorm reduction": [("__reduce_min_sync(kFull, min(fa, fb))",
                             "min(fa, fb)")],
    "no soft loads": [
        ("(i < win && t >= 0 && t < T) ? srow[t] : make_float2(0.f, 0.f)",
         "make_float2(0.1f * (i & 7), -0.1f)")],
    "no shuffles": [("__shfl_sync(kFull, ra, src1)", "ra"),
                    ("__shfl_sync(kFull, rb, src2)", "rb")],
}


def _build(name: str, source: str, build_dir: Path):
    """nvcc ``source`` into its own library; (ctypes library, ptxas
    register and spill lines)."""
    slug = "".join(c if c.isalnum() else "_" for c in name)
    cu = build_dir / f"{slug}.cu"
    so = build_dir / f"lib{slug}.so"
    cu.write_text(source)
    cmd = [vc._nvcc(), *vc.NVCC_FLAGS, "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.sora_viterbi_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.sora_viterbi_decode.restype = ctypes.c_int
    info = "; ".join(line.split(":", 1)[-1].strip()
                     for line in (proc.stdout + proc.stderr).splitlines()
                     if "registers" in line or "spill" in line)
    return lib, info, so


def _soft(batch: int, seed: int) -> torch.Tensor:
    """Noisy terminated codewords (sigma 0.9) as (batch, T, 2) on the card."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, T), dtype=np.uint8)
    bits[:, -6:] = 0
    coded = dvit.encode(torch.from_numpy(bits)).numpy().reshape(batch, T, 2)
    soft = 2.0 * coded - 1.0 + rng.normal(size=coded.shape) * 0.9
    return torch.from_numpy(soft.astype(np.float32)).cuda()


def _ms(lib, soft: torch.Tensor, out: torch.Tensor, reps: int = 50) -> float:
    """Mean ms per launch over ``reps`` launches after 3 warm-up launches."""
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.sora_viterbi_decode(soft.data_ptr(), out.data_ptr(),
                                     soft.shape[0], T, BLOCK, OVERLAP, 1,
                                     stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    for _ in range(3):
        launch()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        launch()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", type=Path, action="append", default=[],
                    help="another version of viterbi.cu to time alongside "
                         "(repeatable)")
    ap.add_argument("--sass", type=Path, help="directory for SASS dumps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("viterbi_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)

    source = vc.SOURCE.read_text()
    variants = {"kernel": source}
    for path in args.compare:
        variants[f"compared {path.name}"] = path.read_text()
    for name, cuts in CUTS.items():
        text = source
        for old, new in cuts:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source "
                                   "exactly once")
            text = text.replace(old, new)
        variants[name] = text
    build_dir = vc.BUILD_DIR / "probe"
    build_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, text in variants.items():
        lib, info, so = _build(name, text, build_dir)
        libs[name] = lib
        print(f"build {name}: {info}", flush=True)
        if args.sass:
            args.sass.mkdir(parents=True, exist_ok=True)
            sass = subprocess.run(
                [str(Path(vc._nvcc()).with_name("cuobjdump")), "-sass",
                 str(so)], capture_output=True, text=True)
            (args.sass / f"{so.stem}.sass").write_text(sass.stdout)

    soft = _soft(B, seed=7)
    out = torch.empty(B, T, dtype=torch.uint8, device="cuda")
    want = vc.decode_blocks_reference(soft, BLOCK, OVERLAP, True)
    times = {name: [] for name in libs}
    order = list(libs)
    for turn in (order, order[::-1]):
        for name in turn:
            times[name].append(_ms(libs[name], soft, out))
            bad = int((out != want).sum())
            print(f"{name}: {times[name][-1]:.4f} ms, {bad} mismatches "
                  f"against the plain version", flush=True)
            if name not in CUTS and bad:
                raise AssertionError(f"{name} disagrees with the plain "
                                     "version")
    sweep = {}
    for batch in SWEEP:
        s = _soft(batch, seed=batch)
        o = torch.empty(batch, T, dtype=torch.uint8, device="cuda")
        sweep[batch] = _ms(libs["kernel"], s, o, reps=30)
        print(f"batch {batch} ({batch * -(-T // BLOCK)} windows): "
              f"{sweep[batch]:.4f} ms", flush=True)
    print(json.dumps({"shape": [B, T, BLOCK, OVERLAP], "ms": times,
                      "sweep_ms": sweep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark of the PyTorch/CUDA port (``sora_tpu_torch``).

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by the names in ``BENCHMARK.json``:
``configs/<file>`` (the deployment), ``traffic/<traffic>.json`` (the mix
that :mod:`benchmark.generator` reads), ``limits/<workload>.json`` (the
limits of the numbers that decide ``correct``) and ``metrics/<name>.py``
(one reader per per-layer metric).  The frozen golden copies
(:mod:`benchmark.golden`) make the frames, and the plain reference
(:mod:`benchmark.reference`) and :mod:`benchmark.judge` decide
``correct``; none of them imports the program.
"""

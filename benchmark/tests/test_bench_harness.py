"""The harness finds a cell's files by name, refuses to run where it
must, and holds no forbidden module."""

import json
import shutil
import subprocess
import sys


from benchmark import run
from benchmark.tests.conftest import TINY


def test_a_new_traffic_file_is_found_by_name(tmp_path, cpu):
    """A cell added by files and entries alone runs: a copy of the
    benchmark with one more traffic mix, limits file and cell."""
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((run.HERE / "traffic" / "sat-a54-1500-8k.json")
                     .read_text())
    mix.update({"formats": [[24, 600]], "streams": 3, "pool": 1,
                "frames": 2, "judged": 1})
    mix["entry"]["args"] = [24]
    (tmp_path / "benchmark" / "traffic" / "new-mix.json").write_text(
        json.dumps(mix))
    shutil.copy(run.HERE / "limits" / "a54-sat-8k.json",
                tmp_path / "benchmark" / "limits" / "new-cell.json")
    spec["workloads"].append({"name": "new-cell", "config": "dot11a-ofdm20",
                              "traffic": "new-mix", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run.run_cell("new-cell", 3, 0.5, False, device=cpu, root=tmp_path)
    assert r["correct"] and r["attempted"] > 0
    assert set(r["metrics"]) == {"rx_msps", "batch_p95_ms", "setup_s"}
    assert list(r)[-1] == "checks"


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sora_tpu_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sora_tpu.phy", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == ["jax", "sora_tpu"]


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "a54-sat-8k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_cli_refuses_without_cuda():
    import os
    r = _cli(run.ROOT, {**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """Beside BENCHMARK.json and the benchmark's files alone, a run fails
    and prints nothing (here at the import of the program, on the CPU)."""
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    code = ("import json, sys\n"
            "from benchmark import run\n"
            "r = run.run_cell('a54-sat-8k', 1, 0.5, False, device='cpu',\n"
            f"                 overrides={TINY['a54-sat-8k']!r})\n"
            "print(json.dumps(r))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "sora_tpu_torch" in r.stderr

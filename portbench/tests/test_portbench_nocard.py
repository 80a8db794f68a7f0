"""A run measures nothing without a card, or outside a checkout of the repo."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from conftest import PKG_DIR, ROOT

ARGS = ["--workload", "sift1m-scan", "--seed", "3000000019", "--seconds", "1", "--trace", "0"]


def _run(cwd, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run([sys.executable, "-m", "portbench.run", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    p = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_run_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(str(tmp_path), {})
    assert p.returncode != 0
    assert p.stdout.strip() == ""

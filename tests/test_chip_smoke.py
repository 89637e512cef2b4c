"""chip_smoke.py on the CPU: it refuses to run without a GPU, its TPC-H
phase (the same code the card runs) matches the sqlite oracle at SF 0.01,
and its kernel phase passes with the kernel interpreted.
Also where the persistent compile cache goes (config.compile_cache_dir)."""

import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_cpu_backend(capsys):
    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.require_gpu(jax.devices())
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_tpch_phase_matches_oracle_q1_q6():
    db, rows, report = chip_smoke.tpch_phase(jax.devices()[:1], 0.01,
                                             queries=(1, 6), warm_reps=1)
    assert sorted(rows) == [1, 6]
    assert len(rows[1]) == 4 and len(rows[6]) == 1
    assert report["stats"]["fallbacks"] == 0
    assert report["stats"]["spmd_runs"] == 0


def test_kernel_phase_interpret():
    report = chip_smoke.kernel_phase(jax.devices()[:1], rows=(40000,),
                                     domains=(4, 32), interpret=True,
                                     reps=1)
    assert sorted(report) == [(40000, 4), (40000, 32)]


def _cache_dir_in_subprocess(**env):
    """The compile-cache directory JAX ends up with after importing the
    engine, in a fresh process."""
    e = {k: v for k, v in os.environ.items()
         if k not in ("MTPU_COMPILE_CACHE", "JAX_COMPILATION_CACHE_DIR")}
    e.update(env, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, jax, monetdb_tpu; "
         "print(json.dumps(jax.config.jax_compilation_cache_dir))"],
        cwd=ROOT, env=e, capture_output=True, text=True, check=True,
        timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_compile_cache_follows_env(tmp_path):
    want = str(tmp_path / "xla")
    assert _cache_dir_in_subprocess(JAX_COMPILATION_CACHE_DIR=want) == want


def test_compile_cache_default_inside_checkout():
    got = _cache_dir_in_subprocess()
    assert got == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()

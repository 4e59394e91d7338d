"""No module of JAX or of the JAX package loads with the benchmark: the
check compares whole top-level names (the program's name begins with the
JAX package's)."""

import subprocess
import sys

import pytest

from bench_port import run


@pytest.mark.parametrize("name,hit", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("prostatemr_3d_cad_cspca_tpu", True), ("prostatemr_3d_cad_cspca_tpu.models", True),
    ("prostatemr_3d_cad_cspca_tpu_torch", False), ("prostatemr_3d_cad_cspca_tpu_torch.serve", False),
    ("jaxtyping", False), ("flaxen", False),
])
def test_names_compare_whole(name, hit, monkeypatch):
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, name, object())
    found = run.forbidden_modules()
    top = name.split(".")[0]
    assert (top in found) == hit or top in before


def test_a_run_loads_nothing_of_jax():
    """Import the harness, every driver, reader and the reference, and the
    program's modules a run uses, in a fresh process: no forbidden module."""
    code = (
        "import sys, glob, os; sys.path.insert(0, %r)\n"
        "from bench_port import run\n"
        "import bench_port.reference.train, bench_port.reference.sliding\n"
        "for f in glob.glob(os.path.join(run.HERE, 'drivers', '*.py')) + "
        "glob.glob(os.path.join(run.HERE, 'metrics', '*.py')):\n"
        "    run.load_file(f, 'x_' + os.path.basename(f).replace('.', '_'))\n"
        "import prostatemr_3d_cad_cspca_tpu_torch.serve, prostatemr_3d_cad_cspca_tpu_torch.ensemble\n"
        "import prostatemr_3d_cad_cspca_tpu_torch.train.trainer\n"
        "import prostatemr_3d_cad_cspca_tpu_torch.data.generators\n"
        "print(run.forbidden_modules())\n" % run.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_the_card_a_run_prints_no_result():
    """On a machine without CUDA, run.py exits non-zero and prints nothing
    on standard output."""
    out = subprocess.run([sys.executable, run.__file__, "--workload", "cfg1_mc4_b2",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_a_run_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run exits non-zero and prints nothing on standard output."""
    import shutil

    shutil.copy(run.ROOT + "/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(run.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "cfg1_mc4_b2",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "not in this checkout" in out.stderr

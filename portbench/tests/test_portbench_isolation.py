"""What a run loads: nothing of JAX or the JAX package (compared by whole
top-level name), and a reference that loads nothing of the port; and a
run that finds no card prints no result."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}


def _python(code: str, cwd: str = ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV,
                          capture_output=True, text=True, timeout=300)


def test_forbidden_names_compare_whole():
    sys.path.insert(0, os.path.join(ROOT, "portbench"))
    import run
    fake = ("gvrt_tpu_torch.x", "3dgvrt_lightfield_tpu_torch", "jaxtyping")
    for name in fake:
        sys.modules.setdefault(name, sys)
    try:
        assert not [m for m in run.forbidden_modules() if m in fake]
        sys.modules["gvrt_tpu"] = sys
        assert "gvrt_tpu" in run.forbidden_modules()
    finally:
        for name in fake + ("gvrt_tpu",):
            if sys.modules.get(name) is sys:
                del sys.modules[name]


def test_run_loads_no_jax():
    """A small serving and training run in a fresh process, through the
    modules run.py loads, leaves no forbidden top-level name behind."""
    out = _python(
        "import sys; sys.path.insert(0, 'portbench'); "
        "sys.path.insert(0, 'portbench/tests'); import run; "
        "from portbench_small import run_small; "
        "run_small('synth300k.serve_orbit'); "
        "run_small('synth300k.train_views'); "
        "print(run.forbidden_modules())")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_loads_nothing_of_the_port():
    out = _python(
        "import sys; import portbench.reference.composite, "
        "portbench.reference.adam, portbench.reference.camera, "
        "portbench.counts; "
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'gvrt_tpu_torch', '3dgvrt_lightfield_tpu_torch', 'gvrt_tpu', "
        "'3dgvrt_lightfield_tpu', 'jax', 'jaxlib'}))")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "synth300k.serve_orbit", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=ENV, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_fails(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/ the run
    exits non-zero and prints no result (no card here either way)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "synth300k.serve_orbit", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=ENV, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""

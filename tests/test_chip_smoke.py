"""chip_smoke.py's contract where there is no card: it refuses a CPU
backend and a directory without the program, selects its phases from its
arguments, and the compile cache lands where the contract says."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_gpu_or_program(tmp_path, alone):
    """On the CPU backend, and in a directory holding chip_smoke.py and
    nothing else of the repo, the script exits non-zero and prints no
    result line."""
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    else:
        script, cwd = os.path.join(REPO, "chip_smoke.py"), str(tmp_path)
    r = _run([script], cwd, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "c")})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    if not alone:
        assert "not 'gpu'" in r.stdout + r.stderr


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_dir(tmp_path, env_dir):
    code = (
        "import jax\n"
        "from allset_tpu.utils.compile_cache import enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    extra = {"PYTHONPATH": REPO}
    if env_dir:
        extra["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    if not env_dir:
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    want = str(tmp_path / env_dir) if env_dir else os.path.join(REPO, ".jax_cache")
    assert r.stdout.split() == [want, want]


def test_phase_selection():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.phases(chip_smoke.parse_args([])) == [
        "device", "ops", "train"]
    assert chip_smoke.phases(chip_smoke.parse_args(["--chips", "4"])) == [
        "device", "four_cards"]
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--chips", "2"])

"""The card bring-up, rehearsed on the CPU: every phase of
``chip_smoke.py`` at its tiny rehearsal sizes, the refusal to run without
a GPU, the peak table, the compile-cache rule and the pinned matmul
precision of the dense products that could otherwise drop to TF32.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from pykrylov_tpu.utils import device  # noqa: E402


@pytest.fixture(scope="module")
def sizes():
    return chip_smoke.Sizes(rehearse=True)


@pytest.mark.parametrize("phase", chip_smoke.PHASES,
                         ids=lambda p: p.__name__)
def test_rehearsal_phase(phase, sizes, capsys):
    phase(sizes)
    out = capsys.readouterr().out
    assert "FAILED" not in out and " ok" in out


def test_rehearsal_four_devices(sizes, capsys):
    chip_smoke.four_cards(sizes)
    out = capsys.readouterr().out
    assert "FAILED" not in out
    assert "cg_pipelined |x4 - x1|" in out


def test_check_raises_and_reports():
    with pytest.raises(AssertionError, match="residual"):
        chip_smoke.check(False, "residual", 1.0, 0.5, "a reason")


def _env_without_gpu():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_smoke_without_gpu_fails_and_prints_no_result(tmp_path):
    env = _env_without_gpu()
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env,
                       timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def test_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True,
                       env=_env_without_gpu(), timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_rehearse_main_result_line(monkeypatch, tmp_path, capsys):
    # the whole rehearsal through main(): its last line names the CPU
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(chip_smoke, "PHASES", chip_smoke.PHASES[-1:])
    chip_smoke.main(["--rehearse"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(last)
    assert out["ok"] is True and out["rehearsal"] is True
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["count"] == len(jax.devices())


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_card_tests_fail_when_asked_for_the_card_without_one():
    # a card run whose GPU plugin fell back to the CPU must not pass as
    # a run of skips
    env = _env_without_gpu()
    env["PYKRYLOV_TEST_ON_CARD"] = "1"
    p = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                        "-p", "no:randomly", "-p", "no:cacheprovider",
                        os.path.join(ROOT, "tests", "test_ff.py")],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=120)
    assert p.returncode != 0
    assert "PYKRYLOV_TEST_ON_CARD=1 but JAX's backend is 'cpu'" in p.stdout
    assert " passed" not in p.stdout and " skipped" not in p.stdout


def test_peak_table():
    assert bench.peak_bandwidth_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    with pytest.raises(ValueError, match="no published HBM peak"):
        bench.peak_bandwidth_gbps("cpu")


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(device.CACHE_ENV, str(tmp_path))
    assert device.compile_cache_dir(ROOT) == str(tmp_path)
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache(ROOT) == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv(device.CACHE_ENV, raising=False)
    path = device.compile_cache_dir(ROOT)
    assert path == os.path.join(ROOT, ".jax_cache")
    assert device.compile_cache_dir(ROOT + os.sep) == path
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_card_info_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    lines = device.card_info()
    assert len(lines) == 1 and "nvidia-smi unavailable" in lines[0]


def _dots(fn, *args):
    text = jax.jit(fn).lower(*args).as_text()
    return [ln for ln in text.splitlines() if "dot_general" in ln]


def test_tall_skinny_products_request_highest():
    from pykrylov_tpu.parallel import TallSkinnyOperator, make_mesh
    mesh = make_mesh(2)
    a = np.random.default_rng(0).standard_normal((40, 6)).astype(np.float32)
    op = TallSkinnyOperator(a, mesh)
    x = jnp.ones(op.nargin, jnp.float32)
    u = jnp.ones(op.nargout, jnp.float32)
    X = jnp.ones((op.nargin, 3), jnp.float32)
    dots = (_dots(lambda v: op @ v, x) + _dots(lambda v: op.T @ v, u)
            + _dots(lambda v: op @ v, X))
    assert dots and all("HIGHEST" in ln for ln in dots), dots


def test_lbfgs_compact_products_request_highest():
    from pykrylov_tpu.ops.lbfgs import (compact_lbfgs_matvec, lbfgs_init,
                                        lbfgs_store)
    n = 12
    rng = np.random.default_rng(1)
    data = lbfgs_init(n, 3, dtype=jnp.float32)
    for _ in range(3):
        s = jnp.asarray(rng.standard_normal(n), jnp.float32)
        data = lbfgs_store(data, s, 2.0 * s)
    v = jnp.ones(n, jnp.float32)
    dots = _dots(lambda d, w: compact_lbfgs_matvec(d, w), data, v)
    assert dots and all("HIGHEST" in ln for ln in dots), dots


def test_poisson3d_dia_matches_coo_path():
    from pykrylov_tpu.gallery.poisson import poisson3d_coo, poisson3d_dia
    from pykrylov_tpu.sparse import formats as F
    for n in (1, 2, 5):
        direct = poisson3d_dia(n)
        coo = F.coo_from_arrays(*poisson3d_coo(n), device=False)
        np.testing.assert_array_equal(np.asarray(F.to_dense(direct)),
                                      np.asarray(F.to_dense(coo)))

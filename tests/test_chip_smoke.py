"""chip_smoke.py's contract off the card: without a GPU it exits non-zero
and prints no result line. On a machine with a GPU the ``gpu`` test runs
it for real (one process on the card: this test process stays on the
CPU)."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _run(cwd, env_extra, timeout):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_refuses_without_gpu():
    r = _run(REPO, {"JAX_PLATFORMS": "cpu"}, 300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_fails_without_the_package(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    r = _run(str(tmp_path), {"JAX_PLATFORMS": "cpu"}, 300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.fixture
def gpu_card():
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py covers this path "
                    "on the card")


@pytest.mark.gpu
def test_smoke_on_gpu(gpu_card):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')

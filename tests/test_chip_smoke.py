"""chip_smoke.py refuses to report success without a GPU."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script_dir, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PANGENIE_TPU_PLATFORM", None)
    return subprocess.run(
        [sys.executable, os.path.join(script_dir, "chip_smoke.py")],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_on_cpu():
    proc = _run(REPO, REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path), str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

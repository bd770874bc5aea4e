"""Guard tests for the entry points in __graft_entry__.py.

A kernel signature change (`_viterbi_iteration` gaining a per-column
switch-cost array) once broke the multi-device dryrun unnoticed. These
tests call the entry points — dryrun_multichip(8) in a fresh subprocess
on a forced 8-device CPU platform — so any future signature drift fails
the suite.
"""

import os
import subprocess
import sys

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_compiles_and_runs():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.remove(REPO)
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    leaves = jax.tree_util.tree_leaves(out)
    assert leaves, "entry() returned no arrays"
    for leaf in leaves:
        assert np.all(np.isfinite(np.asarray(leaf)))


def test_dryrun_multichip_8_devices_subprocess():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        "import __graft_entry__ as g; g.dryrun_multichip(8)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, (
        f"dryrun_multichip(8) failed:\n{proc.stdout}\n{proc.stderr}"
    )

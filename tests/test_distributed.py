"""Multi-host (DCN) layer: helpers + a real 2-process end-to-end run.

The 2-process test launches two fresh interpreters joined through
jax.distributed (Gloo collectives on the CPU backend), runs the demo
genotype command with sharded read counting and a partitioned HMM grid,
and requires the coordinator's VCF to bit-match the reference demo
output — i.e. multi-process execution is semantically invisible.
(The reference scales with a single-process ThreadPool,
src/commands.cpp:864-874; the multi-process layer is its replacement.)
"""

import os
import shutil
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

DEMO = "/root/reference/demo"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_helpers_single_process():
    from pangenie_tpu.parallel import distributed as dist

    assert dist.process_count() == 1
    assert dist.is_coordinator()
    assert dist.partition(5) == [0, 1, 2, 3, 4]
    x = np.arange(7, dtype=np.int64)
    np.testing.assert_array_equal(dist.allreduce_sum(x), x)
    assert dist.gather_objects({"a": 1}) == [{"a": 1}]
    assert list(dist.shard_sequences("abcd", None)) == list("abcd")
    assert list(dist.shard_sequences("abcd", (1, 2))) == ["b", "d"]
    assert list(dist.shard_sequences("abcd", (0, 3))) == ["a", "d"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(pid: int, n: int, port: int, argv, cwd) -> subprocess.Popen:
    env = dict(os.environ)
    env.update(
        PANGENIE_TPU_PLATFORM="cpu",
        PANGENIE_TPU_COORDINATOR=f"127.0.0.1:{port}",
        PANGENIE_TPU_NUM_PROCESSES=str(n),
        PANGENIE_TPU_PROCESS_ID=str(pid),
        PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
    )
    env.pop("XLA_FLAGS", None)  # no virtual-device forcing in children
    return subprocess.Popen(
        [sys.executable, "-m", "pangenie_tpu"] + argv,
        env=env, cwd=cwd,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _strip_header(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("##")]


@pytest.mark.skipif(not os.path.isdir(DEMO), reason="demo data unavailable")
def test_two_process_genotype_bitmatch(tmp_path):
    """2-process demo genotyping + phasing == single-process output
    (which itself bit-matches the reference's committed VCF)."""
    from pangenie_tpu.commands import run_index_command

    for name in ("test-reference.fa", "test-variants.vcf", "test-reads.fa"):
        shutil.copy(os.path.join(DEMO, name), tmp_path)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        run_index_command("test-reference.fa", "test-variants.vcf", 31, "pre")
    finally:
        os.chdir(cwd)

    port = _free_port()
    argv = ["genotype", "-f", "pre", "-i", "test-reads.fa", "-o", "out2p",
            "-g", "-p"]
    procs = [_spawn(pid, 2, port, argv, tmp_path) for pid in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, textwrap.shorten(stderr, 4000)

    got = _strip_header(tmp_path / "out2p_genotyping.vcf")
    expected = _strip_header(os.path.join(DEMO, "test_genotyping.vcf"))
    assert got == expected

    def gts(lines):
        return [ln.split("\t")[9].split(":")[0] for ln in lines
                if not ln.startswith("#")]

    got_p = gts(_strip_header(tmp_path / "out2p_phasing.vcf"))
    exp_p = gts(_strip_header(os.path.join(DEMO, "test_phasing.vcf")))
    assert got_p == exp_p
    # non-coordinator must not have written any output VCF of its own
    assert not (tmp_path / "out2p_genotyping.vcf.proc1").exists()

#!/usr/bin/env python3
"""Smoke test of the genotyper's main path on NVIDIA GPUs.

Usage (from the repository root):

  python3 chip_smoke.py              # one GPU, phases 1-5
  python3 chip_smoke.py --four-gpus  # four GPUs vs one GPU, nothing else

One GPU, every phase runs and any failed phase fails the run:

1. device: JAX's default device is a GPU; prints its kind, the device
   count and ``nvidia-smi``'s name and power limit. Without a GPU the
   script stops here with a non-zero exit.
2. HMM: the batched forward-backward (``hmm.batch``) in float32 against
   the plain ``jax.vmap(forward_backward)`` in float64, on the same
   synthetic columns, at the bench shape (B=128, N=4096, P=32, K=16),
   at A=16 (kernel) and at A=64 (XLA scan); ms per batch of the kernel
   and of the float32 and float64 scans.
3. device counting: PRIME+UPDATE read k-mer counting on the device
   against the host engine, on phase 4's reads and reference; the
   counts must be exactly equal.
4. end to end: ``genotype -r -v -i -g -p`` through the CLI on a
   simulated 20 Mb, 2-chromosome, 123-path panel with 12x 150 bp reads;
   per-phase walls, the HMM dispatch, concordance >= 0.99 vs truth.
5. CPU/GPU parity: a small simulated workload through the same command
   on the GPU (float32) and in a CPU-only child process (float64); GT
   identical except near-ties, likelihoods 10^GL within the bound.

``--four-gpus`` runs phase 5's workload with the device counter forced,
once on four GPUs (hash-partitioned counter, sharded HMM grid) and once
on one, as two child processes, and requires identical VCFs.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback
import types

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".work", "chip_smoke")

# phases 2 and 5: float32 against float64, as normalised likelihoods
# (each column's or genotype set's values sum to 1), absolute error.
# Each column's normalisation sums P^2 = 1024 terms (rounding ~1e-6 in
# float32); with slow recombination the recurrence remembers many
# columns, so errors can add up over N=4096 columns as a random walk
# (~64x). 1e-4 bounds that; small likelihoods are only as exact as
# this absolute error (float32 underflows them, so their log10, the GL,
# is not compared).
F32_ATOL = 1e-4
# log-corrections are sums of two per-column scales: float32 rounding
LOGCORR_RTOL = 1e-6
# phase 4
MIN_CONCORDANCE = 0.99

E2E = dict(mb=20.0, chroms=2, samples=61, coverage=12.0, read_len=150,
           distance=150, seed=11)
# four chromosomes: four HMM work items, one per card in --four-gpus
SMALL = dict(mb=1.0, chroms=4, samples=22, coverage=12.0, read_len=150,
             distance=150, seed=11)


class PhaseFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def nvidia_smi() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def inputs(params: dict) -> str:
    from benchmarks.genome_scale import build_inputs

    return build_inputs(types.SimpleNamespace(**params), WORK)


def genotype_argv(casedir: str, outpref: str, *extra: str) -> list[str]:
    n = str(os.cpu_count() or 1)
    return [
        "genotype", "-i", os.path.join(casedir, "reads.fa"),
        "-r", os.path.join(casedir, "ref.fa"),
        "-v", os.path.join(casedir, "panel.vcf"),
        "-o", outpref, "-j", n, "-t", n, *extra,
    ]


def run_child(argv: list[str], env_extra: dict, log: str) -> None:
    """Run the CLI in a child process; its output goes to ``log``."""
    env = dict(os.environ, **env_extra)
    with open(log, "w") as fh:
        proc = subprocess.run(
            [sys.executable, "-m", "pangenie_tpu", *argv],
            cwd=REPO, env=env, stdout=fh, stderr=subprocess.STDOUT,
            timeout=900,
        )
    check(proc.returncode == 0,
          f"child {' '.join(argv[:1])} exited {proc.returncode}; see {log}")


# --------------------------------------------------------------- phases


def phase_device():
    import jax

    devices = jax.devices()
    d = devices[0]
    check(d.platform == "gpu", f"default device is {d.platform!r}, not a GPU")
    print(f"device: {d.device_kind}, {len(devices)} device(s)")
    for line in nvidia_smi():
        print(f"nvidia-smi: {line}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def _best_ms(fn, x, reps=3) -> float:
    import jax

    jax.block_until_ready(fn(x))  # compile and warm up
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def _normalised(posteriors):
    import numpy as np

    p = np.asarray(posteriors, np.float64)
    s = p.sum(axis=(-1, -2), keepdims=True)
    return p / np.where(s > 0, s, 1.0)


def phase_hmm():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pangenie_tpu.hmm import batch as hb
    from pangenie_tpu.hmm.forward_backward import forward_backward
    from pangenie_tpu.utils.synthetic import synthetic_columns

    fb = jax.jit(hb.forward_backward_batch)
    scan = jax.jit(jax.vmap(forward_backward))
    # multiallelic columns take diploid read counts: the default cn=1
    # counts fit no genotype at A > 2, so their likelihoods underflow
    # float32 (see synthetic_columns)
    cases = [  # B, N, P, K, A, diploid, expected dispatch
        (128, 4096, 32, 16, 2, False, "pallas_triton"),
        (16, 2048, 32, 32, 16, True, "pallas_triton"),
        (4, 1024, 32, 64, 64, True, "xla_scan"),
    ]
    for B, N, P, K, A, diploid, expect in cases:
        host = synthetic_columns(
            n_columns=N, n_paths=P, n_kmers=K, n_alleles=A,
            batch_dims=(B,), dtype=np.float64, seed=B + A, diploid=diploid,
        )
        c64 = type(host)(*[jnp.asarray(x) for x in host])
        c32 = type(host)(*[
            jnp.asarray(x.astype(np.float32) if x.dtype == np.float64 else x)
            for x in host
        ])
        post, corr = fb(c32)
        dispatch = hb.last_dispatch
        ref_post, ref_corr = scan(c64)
        err = float(np.max(np.abs(_normalised(post) - _normalised(ref_post))))
        rc = np.asarray(ref_corr)
        corr_err = float(np.max(
            np.abs(np.asarray(corr, np.float64) - rc)
            / np.maximum(np.abs(rc), 1e-30)))
        finite = bool(np.all(np.isfinite(np.asarray(post))))
        ms = _best_ms(fb, c32)
        ms32 = _best_ms(scan, c32)
        ms64 = _best_ms(scan, c64)
        print(
            f"hmm B={B} N={N} P={P} K={K} A={A}: dispatch={dispatch} "
            f"posterior max|err|={err:.3e} (bound {F32_ATOL:g}) "
            f"log-corr rel err={corr_err:.3e} (bound {LOGCORR_RTOL:g}); "
            f"ms/batch: dispatched {ms:.3f}, f32 scan {ms32:.3f}, "
            f"f64 scan {ms64:.3f}"
        )
        check(dispatch == expect, f"dispatch {dispatch}, expected {expect}")
        check(finite and post.shape == (B, N, A, A), "bad posteriors")
        check(err <= F32_ATOL, f"posterior error {err:.3e}")
        check(corr_err <= LOGCORR_RTOL, f"log-correction error {corr_err:.3e}")


def phase_counting(casedir: str):
    import numpy as np

    from pangenie_tpu.kmers.counter import ExactKmerCounter
    from pangenie_tpu.kmers.device_counter import count_file_primed_device

    reads = os.path.join(casedir, "reads.fa")
    corpus = [os.path.join(casedir, "ref.fa")]
    t0 = time.monotonic()
    host = ExactKmerCounter.count_file_primed(reads, corpus, 31)
    t_host = time.monotonic() - t0
    t0 = time.monotonic()
    dev = count_file_primed_device(reads, corpus, 31)
    t_dev = time.monotonic() - t0
    print(f"counting: {len(host.keys)} graph k-mers, "
          f"{os.path.getsize(reads) / 1e6:.1f} MB of reads; "
          f"host {t_host:.2f} s, device {t_dev:.2f} s (incl. compile)")
    check(np.array_equal(host.keys, dev.keys), "k-mer keys differ")
    check(np.array_equal(host.counts, dev.counts), "k-mer counts differ")
    check(int(host.counts.sum()) > 0, "no k-mer counted")


def phase_e2e(casedir: str):
    from pangenie_tpu import cli
    from pangenie_tpu.eval.concordance import genotype_concordance
    from pangenie_tpu.hmm import batch as hb
    from pangenie_tpu.utils import timer

    outpref = os.path.join(WORK, "e2e")
    t0 = time.monotonic()
    rc = cli.main(genotype_argv(casedir, outpref, "-g", "-p"))
    wall = time.monotonic() - t0
    check(rc == 0, f"genotype exited {rc}")
    for name, seconds in timer.last_phases.items():
        print(f"e2e phase {name}: {seconds:.2f} s")
    result = genotype_concordance(outpref + "_genotyping.vcf",
                                  os.path.join(casedir, "truth.vcf"))
    check(os.path.getsize(outpref + "_phasing.vcf") > 0, "no phasing VCF")
    print(f"e2e: wall {wall:.2f} s, dispatch {hb.last_dispatch}, "
          f"{result.total} variants, concordance {result.concordance:.5f} "
          f"(bound >= {MIN_CONCORDANCE})")
    check(result.concordance >= MIN_CONCORDANCE,
          f"concordance {result.concordance:.5f}")


def _genotype_fields(vcf: str) -> dict:
    """(chrom, pos) -> (GT, [GL...]) of a genotyping VCF."""
    out = {}
    with open(vcf) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            keys = f[8].split(":")
            vals = dict(zip(keys, f[9].split(":")))
            gl = [float(x) for x in vals.get("GL", "").split(",") if x]
            out[(f[0], int(f[1]))] = (vals["GT"], gl)
    return out


def _print_slack(gl: float) -> float:
    """How far 10**gl may move when gl is printed to 4 significant
    digits ({:.4g}): half a unit of the 4th digit, on linear scale."""
    if gl == 0 or not math.isfinite(gl):
        return 0.0
    unit = 10.0 ** (math.floor(math.log10(abs(gl))) - 3)
    return 1.01 * 10.0 ** gl * math.log(10) * 0.5 * unit


def _gl_diff(a: float, b: float) -> float:
    """|10^a - 10^b| beyond the two values' print rounding."""
    return max(0.0, abs(10.0 ** a - 10.0 ** b)
               - _print_slack(a) - _print_slack(b))


def phase_parity(casedir: str):
    from pangenie_tpu import cli

    gpu_out = os.path.join(WORK, "parity_gpu")
    cpu_out = os.path.join(WORK, "parity_cpu")
    check(cli.main(genotype_argv(casedir, gpu_out)) == 0, "GPU run failed")
    # the child stays off the card: JAX there sees only the CPU
    run_child(genotype_argv(casedir, cpu_out),
              {"JAX_PLATFORMS": "cpu", "PANGENIE_TPU_PLATFORM": "cpu"},
              cpu_out + ".log")
    gpu = _genotype_fields(gpu_out + "_genotyping.vcf")
    cpu = _genotype_fields(cpu_out + "_genotyping.vcf")
    check(gpu.keys() == cpu.keys(), "the two VCFs hold different records")
    ties = mismatched = 0
    max_diff = 0.0
    for key, (gt_c, gl_c) in cpu.items():
        gt_g, gl_g = gpu[key]
        check(len(gl_c) == len(gl_g), f"GL count differs at {key}")
        for a, b in zip(gl_c, gl_g):
            max_diff = max(max_diff, _gl_diff(a, b))
        top = sorted(gl_c, reverse=True)[:2]
        near_tie = len(top) == 2 and _gl_diff(top[0], top[1]) <= F32_ATOL
        ties += near_tie
        if gt_c != gt_g and not near_tie:
            mismatched += 1
    print(f"parity: {len(cpu)} records, {ties} near-ties (CPU's two best "
          f"likelihoods within {F32_ATOL:g}), {mismatched} GT mismatches "
          f"outside them, max |10^GL difference| beyond print rounding "
          f"{max_diff:.3e} (bound {F32_ATOL:g})")
    check(mismatched == 0, f"{mismatched} GT mismatches")
    check(max_diff <= F32_ATOL, f"GL difference {max_diff:.3e}")


def four_gpus() -> dict:
    """Phase 5's workload with the device counter forced, on four GPUs
    and on one, in two child processes; the VCFs must be identical."""
    casedir = inputs(SMALL)
    legs = {}
    for n_cards, env in ((4, {}), (1, {"CUDA_VISIBLE_DEVICES": "0"})):
        outpref = os.path.join(WORK, f"gpus{n_cards}")
        t0 = time.monotonic()
        run_child(genotype_argv(casedir, outpref),
                  dict(env, PANGENIE_TPU_COUNTER="device"),
                  outpref + ".log")
        with open(outpref + ".log") as fh:
            log = fh.read()
        if n_cards == 4:
            check("sharded device PRIME+UPDATE counter over 4 devices" in log,
                  "the four-card run did not use the sharded counter")
            check(re.search(r"HMM grid of \d+ items sharded over 4 devices",
                            log) is not None,
                  "the four-card run did not shard the HMM grid")
        with open(outpref + "_genotyping.vcf") as fh:
            legs[n_cards] = [l for l in fh if not l.startswith("##")]
        print(f"{n_cards} GPU(s): {len(legs[n_cards]) - 1} records, "
              f"{time.monotonic() - t0:.1f} s")
    check(legs[4] == legs[1], "four-GPU and one-GPU VCFs differ")
    print("four-GPU VCF identical to the one-GPU VCF")

    import jax  # the children have exited; now this process may open

    devices = jax.devices()
    check(devices[0].platform == "gpu" and len(devices) == 4,
          f"expected four GPUs, found {devices}")
    for line in nvidia_smi():
        print(f"nvidia-smi: {line}")
    return {"platform": "gpu", "kind": devices[0].device_kind, "count": 4}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run the four-GPU path against one GPU, nothing else")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "pangenie_tpu")):
        print("chip_smoke: the pangenie_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # a missing GPU is an error, never a run on the CPU
    os.environ["PANGENIE_TPU_PLATFORM"] = "gpu"
    os.makedirs(WORK, exist_ok=True)

    if args.four_gpus:
        try:
            device = four_gpus()
        except Exception:
            traceback.print_exc()
            return 1
        print(json.dumps({"ok": True, "device": device}), flush=True)
        return 0

    try:
        device = phase_device()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: no GPU; nothing was run", file=sys.stderr)
        return 1

    failed = []

    def phase(name, fn, *a):
        print(f"== phase {name}", flush=True)
        t0 = time.monotonic()
        try:
            fn(*a)
            status = "ok"
        except Exception:
            traceback.print_exc()
            failed.append(name)
            status = "FAILED"
        print(f"== phase {name}: {status} ({time.monotonic() - t0:.1f} s)",
              flush=True)

    phase("hmm", phase_hmm)
    case_e2e = inputs(E2E)
    phase("counting", phase_counting, case_e2e)
    phase("e2e", phase_e2e, case_e2e)
    phase("parity", phase_parity, inputs(SMALL))
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

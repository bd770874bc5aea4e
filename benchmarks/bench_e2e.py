"""Reproducible end-to-end benchmark: simulate a workload, run the
fused pipeline, report wall time per phase + concordance.

Examples:

    # 1Mb / 22 samples / 25x (f32 on an accelerator by default)
    python benchmarks/bench_e2e.py --length 1000000 --samples 22

    # 4Mb / 60 samples (auto haplotype-sampling kicks in at >100 paths)
    python benchmarks/bench_e2e.py --length 4000000 --samples 60 \\
        --cluster-fraction 0.2 --sv-fraction 0.05
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--length", type=int, default=1_000_000)
    parser.add_argument("--samples", type=int, default=22)
    parser.add_argument("--coverage", type=float, default=25.0)
    parser.add_argument("--read-length", type=int, default=150)
    parser.add_argument("--cluster-fraction", type=float, default=0.0)
    parser.add_argument("--sv-fraction", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--workdir", default=None)
    args = parser.parse_args()

    import numpy as np

    from pangenie_tpu.commands import run_single_command
    from pangenie_tpu.eval.concordance import genotype_concordance
    from pangenie_tpu.utils import simulate as sim

    workdir = args.workdir or tempfile.mkdtemp(prefix="pangenie_bench_")
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        rng = np.random.default_rng(args.seed)
        reference = sim.random_reference(args.length, rng)
        variants = sim.simulate_panel(
            reference, nr_samples=args.samples, rng=rng,
            cluster_fraction=args.cluster_fraction,
            sv_fraction=args.sv_fraction,
        )
        sim.write_inputs(".", reference, variants)
        hap1, hap2 = sim.haplotype_sequences(reference, variants, 0)
        sim.simulate_reads(
            hap1, hap2, args.coverage, args.read_length, rng,
            outfile="reads.fa",
        )
        with open("truth.vcf", "w") as out:
            out.write(
                "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\tS\n"
            )
            for v in variants:
                a, b = sorted(v.genotypes[0])
                out.write(
                    f"chr1\t{v.position + 1}\t.\t{v.ref.decode()}\t"
                    f"{','.join(x.decode() for x in v.alts)}\t.\tPASS\t.\t"
                    f"GT\t{a}/{b}\n"
                )

        t0 = time.monotonic()
        run_single_command("reads.fa", "ref.fa", "panel.vcf", 31, "out")
        wall = time.monotonic() - t0
        result = genotype_concordance("out_genotyping.vcf", "truth.vcf")
        print(json.dumps({
            "length_bp": args.length,
            "samples": args.samples,
            "paths": 2 * args.samples + 1,
            "variants": result.total,
            "wall_s": round(wall, 2),
            "variants_per_s": round(result.total / wall, 1),
            "concordance": round(result.concordance, 5),
            "no_call": result.no_call,
            "workdir": workdir,
        }))
    finally:
        os.chdir(cwd)


if __name__ == "__main__":
    main()

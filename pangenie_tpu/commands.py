"""Pipeline drivers: index / genotype / single / vcf / sampling.

Python equivalents of the reference command orchestration
(src/commands.cpp): same phase structure, same intermediate artifacts
(path-segments FASTA, per-chromosome kmer TSVs, serialized graphs +
unique-kmer maps), same defaults. Cereal archives are replaced by
pickle files; the kmer TSV format is byte-compatible with the
reference's (`#chromosome\tstart\tend\tunique_kmers\tunique_kmers_overhang`).

Threading differences are intentional: the reference dispatches one
CPU thread per chromosome; here the HMM work runs as JAX scans (the
device is the parallelism), and host-side phases run sequentially.
"""

from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np
from dataclasses import dataclass, field
from typing import Dict, List

from . import backend
from .hmm.columns import densify_records
from .hmm.genotyping import PairHMM
from .utils.timer import PhaseSummary
from .hmm.sampling import HaplotypeSampler
from .kmers.counter import ExactKmerCounter, KmerCounter
from .kmers.unique import StepwiseUniqueKmerComputer, UniqueKmerComputer, UniqueKmersRecord
from .model.probabilities import ProbabilityTable
from .panel.builder import PanelBuilder
from .panel.graph import ChromosomeGraph
from .panel.sampling import PathSampler
from .panel.variant import GenotypeLikelihoods, SampledPanel


def check_input_file(filename: str) -> None:
    """Reject gzipped inputs, as the reference does
    (src/commands.cpp:42-56)."""
    if filename.endswith(".gz"):
        raise RuntimeError(
            f"File: {filename} is gzipped. PanGenie requires an uncompressed file."
        )
    if not os.path.exists(filename):
        raise RuntimeError(f"File: {filename} does not exist.")


@dataclass
class UniqueKmersMap:
    """Serialized index payload (reference src/commands.hpp:11-28)."""

    kmersize: int = 0
    add_reference: bool = False
    unique_kmers: Dict[str, List[UniqueKmersRecord]] = field(default_factory=dict)
    runtimes: Dict[str, float] = field(default_factory=dict)
    sampling_runtimes: Dict[str, float] = field(default_factory=dict)


@dataclass
class Results:
    """Genotyping results per chromosome (src/commands.cpp:59-73)."""

    result: Dict[str, List[GenotypeLikelihoods]] = field(default_factory=dict)
    runtimes: Dict[str, float] = field(default_factory=dict)
    # chromosome -> (mask[M], vals[M, 3]): array-resident likelihoods
    # for canonical biallelic variants (single-subset normalized runs);
    # rows masked here hold empty dicts in `result` and the VCF writers
    # read the arrays directly
    bulk: Dict[str, tuple] = field(default_factory=dict)


def _use_device_counter(readfile: str = "", n_keys: int = 0) -> bool:
    """Route read k-mer counting through the device engine.

    PANGENIE_TPU_COUNTER=device forces it, =host forbids it; otherwise
    AUTO: the device engine engages on an accelerator once the read
    volume amortizes its fixed costs, which scale with the GRAPH-TABLE
    size (every flush re-sorts the n_keys-long table together with the
    buffered windows, and the table crosses to and from the device
    once). AUTO requires the read volume to exceed ~12x the key count
    and at least ~512 Mbp. These thresholds predate any GPU
    measurement and are to be derived again from one."""
    env = os.environ.get("PANGENIE_TPU_COUNTER", "").lower()
    if env == "device":
        return True
    if env == "host":
        return False
    if not backend.is_accelerator():
        return False
    try:
        size = os.path.getsize(readfile)
    except OSError:
        return False
    if readfile.endswith(".gz"):
        # DNA FASTA/FASTQ compresses ~4x; estimate decompressed bases
        size *= 4
    elif readfile.endswith((".fastq", ".fq")):
        # quality lines + headers roughly double the bytes per base
        size //= 2
    return size > max(512 * 1024 * 1024, 12 * n_keys)


def _device_table_fits(n_keys: int, n_devices: int,
                       budget: int | None = None) -> bool:
    """Per-device footprint of the hash-partitioned PRIME+UPDATE
    table: ~12 B/key (tagged key pair + count) plus the flush
    workspace (two uint32 buffers, capped like PrimedDeviceCounter's
    capacity), against the device's free memory."""
    if budget is None:
        budget = backend.device_bytes_free()
    per_dev = (n_keys + max(1, n_devices) - 1) // max(1, n_devices)
    workspace = 16 * min(16 * max(per_dev, 1 << 20), 64 << 20)
    return 12 * per_dev + workspace < budget


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)


def _coordinator_file(filename: str) -> str:
    """Output files are written by the coordinator only under multi-host
    execution (peer processes would race on a shared filesystem); ""
    disables the write at every call site."""
    from .parallel import distributed as dist

    return filename if dist.is_coordinator() else ""


def _save(obj, filename: str) -> None:
    with open(filename, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def _load(filename: str):
    with open(filename, "rb") as f:
        return pickle.load(f)


def _read_counter(
    readfile: str,
    segment_file: str,
    kmersize: int,
    count_only_graph: bool,
    nr_threads: int = 1,
    hash_size: int = 3_000_000_000,
    prime_keys=None,
) -> KmerCounter:
    from .parallel import distributed as dist

    if readfile.endswith(".jf"):
        from .kmers.jf_reader import read_jf

        _log("Read pre-computed read kmer counts ...")
        return read_jf(readfile, kmersize)
    _log("Count kmers in reads ...")
    if count_only_graph:
        # multi-host: each process streams a disjoint read shard against
        # the shared graph-kmer table; the count vectors are summed over
        # DCN (the reference's lock-free hash merge becomes an all-reduce)
        shard = None
        if dist.process_count() > 1:
            shard = (dist.process_index(), dist.process_count())
            _log(
                f"  multi-host: process {shard[0]}/{shard[1]} counts every "
                f"{shard[1]}-th read"
            )
        n_keys = len(prime_keys) if prime_keys is not None else 0
        if _use_device_counter(readfile, n_keys):
            import jax

            devices = jax.devices()
            # the `-e` hash size bounds the streaming block (the table
            # itself is O(graph kmers)); /64 maps the reference's 3e9
            # entry default to ~48 MB blocks
            block = int(min(max(hash_size // 64, 1 << 22), 1 << 28))
            if not _device_table_fits(n_keys, len(devices)):
                _log(
                    "  graph table exceeds the devices' free memory; "
                    "counting on the host engine"
                )
                counter = ExactKmerCounter.count_file_primed(
                    readfile, [segment_file], kmersize,
                    n_threads=nr_threads, shard=shard, keys=prime_keys,
                )
            elif len(devices) > 1:
                # pod-scale layout: the graph table hash-partitions
                # across the local mesh; read k-mers route to their
                # owner device through an all_to_all per ingest step
                from .kmers.device_counter import count_file_primed_sharded

                _log(
                    "  using sharded device PRIME+UPDATE counter over "
                    f"{len(devices)} devices"
                )
                counter = count_file_primed_sharded(
                    readfile, kmersize, prime_keys, shard=shard,
                    block_bases=block,
                )
            else:
                from .kmers.device_counter import count_file_primed_device

                _log("  using device PRIME+UPDATE counter")
                counter = count_file_primed_device(
                    readfile, [segment_file], kmersize, block_bases=block,
                    shard=shard, keys=prime_keys,
                )
        else:
            counter = ExactKmerCounter.count_file_primed(
                readfile, [segment_file], kmersize, n_threads=nr_threads,
                shard=shard, keys=prime_keys,
            )
        if shard is not None:
            counter.counts = dist.allreduce_sum(counter.counts)
        return counter
    return ExactKmerCounter.count_file(readfile, kmersize)


# ---------------------------------------------------------------------------
# index
# ---------------------------------------------------------------------------


def run_index_command(
    reffile: str,
    vcffile: str,
    kmersize: int,
    outname: str,
    nr_jellyfish_threads: int = 1,
    add_reference: bool = True,
    hash_size: int = 3_000_000_000,
) -> int:
    """PanGenie-index (reference src/commands.cpp:592-728).

    ``hash_size`` is the CLI's -e (the reference's jellyfish hash
    size, src/commands.cpp:647); here it bounds the per-thread corpus
    extraction chunk, the analogous memory knob."""
    check_input_file(reffile)
    check_input_file(vcffile)

    backend.platform()
    summary = PhaseSummary("PanGenie-index")
    segment_file = outname + "_path_segments.fasta"
    unique_kmers_list = UniqueKmersMap(kmersize=kmersize, add_reference=add_reference)

    _log("Determine allele sequences ...")
    builder = PanelBuilder(vcffile, reffile, segment_file, kmersize, add_reference)
    chromosomes = builder.get_chromosomes()
    _log(f"Found {len(chromosomes)} chromosome(s) in the VCF.")

    summary.phase("reading input files")

    _log("Count kmers in graph ...")
    genomic_kmer_counts = ExactKmerCounter.count_file(
        segment_file, kmersize, n_threads=nr_jellyfish_threads,
        block_bases=int(min(max(hash_size // 64, 1 << 22), 1 << 28)),
    )
    summary.phase("counting kmers in graph")

    import threading as _threading

    idx_thread = None
    if hasattr(genomic_kmer_counts, "prepare_lookup_index"):
        # build the selection phase's lookup index while graphs pickle
        idx_thread = _threading.Thread(
            target=genomic_kmer_counts.prepare_lookup_index, daemon=True
        )
        idx_thread.start()

    _log("Serialize Graph objects ...")
    for chromosome in chromosomes:
        _save(builder.graphs[chromosome], f"{outname}_{chromosome}_Graph.pkl")
    summary.phase("writing Graph objects to disk")

    _log("Determine unique kmers ...")
    if idx_thread is not None:
        idx_thread.join()

    def _index_chromosome(chromosome):
        t = time.monotonic()
        graph = builder.graphs[chromosome]
        computer = StepwiseUniqueKmerComputer(genomic_kmer_counts, graph)
        records = computer.compute_unique_kmers(
            f"{outname}_{chromosome}_kmers.tsv.gz", delete_processed_variants=True
        )
        return chromosome, records, time.monotonic() - t

    # per-chromosome work is independent; the native k-mer lookups and
    # numpy enumeration release the GIL, so threads use host cores (the
    # reference's ThreadPool over chromosomes, src/commands.cpp:677-687)
    from concurrent.futures import ThreadPoolExecutor

    workers = max(1, min(nr_jellyfish_threads, len(chromosomes)))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for chromosome, records, elapsed in pool.map(
            _index_chromosome, chromosomes
        ):
            unique_kmers_list.unique_kmers[chromosome] = records
            unique_kmers_list.runtimes[chromosome] = elapsed

    summary.phase("determining unique kmers")

    _log("Storing unique kmer information ...")
    _save(unique_kmers_list, outname + "_UniqueKmersMap.pkl")
    summary.phase("writing UniqueKmersMap to disk")

    summary.print_summary()
    return 0


# ---------------------------------------------------------------------------
# genotype (from index)
# ---------------------------------------------------------------------------


def fill_read_kmercounts(
    chromosome: str,
    unique_kmers_map: UniqueKmersMap,
    read_kmer_counts: KmerCounter,
    probabilities: ProbabilityTable,
    precomputed_prefix: str,
    kmer_coverage: int,
    panel_size: int,
    recombrate: float,
    effective_N: float,
    add_reference: bool,
    output_paths: str,
    allele_penalty: int,
) -> None:
    """Stream the kmer TSV, fill read counts + local coverage, then run
    haplotype sampling (reference src/commands.cpp:76-152).

    K-mer strings are encoded and looked up in bulk (one batched
    abundance query per chromosome instead of a Python call per k-mer);
    counts/coverage scatter back via per-record array ops.
    """
    import gzip

    import numpy as np

    from .kmers.mer import decode_kmer, encode_kmer_fields

    filename = f"{precomputed_prefix}_{chromosome}_kmers.tsv.gz"
    records = unique_kmers_map.unique_kmers[chromosome]
    kmersize = unique_kmers_map.kmersize
    min_cov = kmer_coverage // 4
    max_cov = kmer_coverage * 4

    # pass 1: parse the TSV. The kmer columns stay as comma-joined
    # FIELDS (length determines the count) — splitting per kmer built
    # millions of short strings only for the bulk encode to re-join
    kmer_fields: List[str] = []
    flank_fields: List[str] = []
    n_kmers: List[int] = []
    n_flanks: List[int] = []
    var_index = 0
    field_w = kmersize + 1
    with gzip.open(filename, "rt") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            tokens = line.split("\t")
            assert len(tokens) == 5
            if tokens[0].startswith("#"):
                continue
            assert tokens[0] == chromosome
            assert int(tokens[1]) == records[var_index].get_variant_position()
            t3, t4 = tokens[3], tokens[4]
            if t3 != "nan":
                kmer_fields.append(t3)
                n_kmers.append((len(t3) + 1) // field_w)
            else:
                n_kmers.append(0)
            if t4 != "nan":
                flank_fields.append(t4)
                n_flanks.append((len(t4) + 1) // field_w)
            else:
                n_flanks.append(0)
            var_index += 1

    # pass 2: batched encode + abundance lookups
    encoded_kmers = encode_kmer_fields(kmer_fields, kmersize)
    counts = read_kmer_counts.get_abundances(encoded_kmers)
    flank_counts = read_kmer_counts.get_abundances(
        encode_kmer_fields(flank_fields, kmersize)
    )

    # zero-probability warnings (rare; reference src/commands.cpp:118-126)
    probs = probabilities.get_probabilities(kmer_coverage, counts)
    bad = np.nonzero(~(probs > 0).any(axis=1))[0]
    if len(bad):
        sizes_k = np.asarray(n_kmers, dtype=np.int64)
        rec_of_kmer = np.repeat(np.arange(len(records)), sizes_k)
        for b in bad.tolist():
            r = records[int(rec_of_kmer[b])]
            _log(
                "Warning: only zero probabilities for "
                f"{decode_kmer(int(encoded_kmers[b]), kmersize)} at "
                f"{chromosome} {r.get_variant_position()}"
            )

    # pass 3: scatter read counts + local coverage back into records.
    # Local coverage per record = int mean of flanking counts within
    # [peak/4, 4*peak], fallback peak (reference src/kmerparser.cpp:30-49)
    sizes_f = np.asarray(n_flanks, dtype=np.int64)
    valid = (flank_counts >= min_cov) & (flank_counts <= max_cov)
    csum_v = np.concatenate([[0], np.cumsum(np.where(valid, flank_counts, 0))])
    csum_n = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
    ends = np.cumsum(sizes_f)
    starts = ends - sizes_f
    seg_sum = csum_v[ends] - csum_v[starts]
    seg_n = csum_n[ends] - csum_n[starts]
    coverages = np.where(
        (seg_n > 0) & (seg_sum > 0),
        seg_sum // np.maximum(seg_n, 1),
        kmer_coverage,
    ).tolist()

    offset = 0
    for i, record in enumerate(records):
        nk = n_kmers[i]
        if nk == record.size():
            record.set_readcounts(counts[offset : offset + nk])
        else:
            # TSV line and record disagree; per-kmer update keeps the
            # reference's bounds behaviour
            for j in range(nk):
                record.update_readcount(j, int(counts[offset + j]))
        offset += nk
        record.set_coverage(coverages[i])

    t = time.monotonic()
    HaplotypeSampler(
        records,
        panel_size,
        recombrate,
        effective_N,
        None,
        add_reference,
        output_paths,
        chromosome,
        allele_penalty,
    )
    unique_kmers_map.sampling_runtimes[chromosome] = time.monotonic() - t


def _genotyping_block(
    chromosomes: List[str],
    unique_kmers_list: UniqueKmersMap,
    probabilities: ProbabilityTable,
    results: Results,
    only_genotyping: bool,
    only_phasing: bool,
    effective_N: float,
    recombrate: float,
    sampling_size: int,
    output_panel: bool,
    chrom_to_sampled: Dict[str, List[SampledPanel]],
) -> None:
    """Shared genotyping/phasing section
    (reference src/commands.cpp:908-1009)."""
    nr_paths = 0
    for chromosome in chromosomes:
        records = unique_kmers_list.unique_kmers[chromosome]
        if records:
            nr_paths = records[0].get_nr_paths()
            break

    if sampling_size == 0 or sampling_size > nr_paths:
        sampling_size = nr_paths

    path_sampler = PathSampler(nr_paths)
    subsets: List[List[int]] = []
    path_sampler.partition_samples(subsets, sampling_size)

    if not only_phasing:
        _log(
            f"Sampled {len(subsets)} subset(s) of paths each of size "
            f"{sampling_size} for genotyping."
        )

    phasing_paths: List[int] = []
    nr_phasing_paths = min(nr_paths, 30)
    path_sampler.select_single_subset(phasing_paths, nr_phasing_paths)
    if not only_genotyping:
        _log(f"Sampled {len(phasing_paths)} paths to be used for phasing.")

    _log("Construct HMM and run core algorithm ...")
    from .parallel import distributed as dist

    t = time.monotonic()
    dtype = backend.hmm_dtype()
    # the (chromosome x path-subset) grid as an explicit work list; under
    # multi-host execution it is partitioned round-robin across processes
    # (each process drives its local devices) and the per-variant results
    # are gathered to the coordinator — the DCN analogue of the
    # reference's result mutex (src/commands.cpp:163-185)
    run_specs: List[tuple] = []  # (chromosome, genotyping?, paths)
    for chromosome in chromosomes:
        if not only_genotyping:
            run_specs.append((chromosome, False, phasing_paths))
        if not only_phasing:
            for subset in subsets:
                run_specs.append((chromosome, True, subset))
    local_indices = dist.partition(len(run_specs))
    if dist.process_count() > 1:
        _log(
            f"  multi-host: process {dist.process_index()}/"
            f"{dist.process_count()} runs {len(local_indices)}/"
            f"{len(run_specs)} HMM work items"
        )

    all_runs: List[tuple] = []
    base_index: Dict[str, int] = {}  # chromosome -> min global run index
    cols_cache: Dict[tuple, tuple] = {}  # (chrom, paths) -> built columns
    # chromosome-level densification shared by every subset run; built
    # in parallel (bulk numpy releases the GIL)
    local_chroms = []
    for idx in local_indices:
        chromosome = run_specs[idx][0]
        if chromosome not in local_chroms:
            local_chroms.append(chromosome)

    import jax.numpy as jnp

    np_dtype = np.dtype(jnp.dtype(dtype).name)

    def _densify(chromosome):
        records = unique_kmers_list.unique_kmers[chromosome]
        return chromosome, (
            densify_records(records, probabilities, np_dtype)
            if records
            else None
        )

    if len(local_chroms) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(4, len(local_chroms))) as p:
            dense_cache = dict(p.map(_densify, local_chroms))
    else:
        dense_cache = dict(map(_densify, local_chroms))
    # with a single genotyping subset no cross-subset combine follows,
    # so normalization happens vectorized inside the posterior scatter
    # (combine into the phasing run's empty likelihood maps is the
    # identity, so pre-normalized values survive it)
    normalize_in_run = len(subsets) == 1
    for idx in local_indices:
        chromosome, is_genotyping, paths = run_specs[idx]
        records = unique_kmers_list.unique_kmers[chromosome]
        base_index.setdefault(chromosome, idx)
        cols_key = (chromosome, tuple(paths))
        hmm = PairHMM(
            records, probabilities, is_genotyping, not is_genotyping,
            recombrate, False, effective_N, paths,
            normalize=is_genotyping and normalize_in_run,
            dtype=dtype, defer=True, dense=dense_cache[chromosome],
            prebuilt=cols_cache.get(cols_key), bulk=True,
        )
        # genotyping + phasing over the same subset share columns
        cols_cache.setdefault(cols_key, hmm.shared_columns())
        all_runs.append((chromosome, hmm))
    del dense_cache, cols_cache
    # the (chromosome x subset) grid executes as batched device scans;
    # PANGENIE_TPU_PROFILE=<dir> wraps it in a jax.profiler trace
    profile_dir = os.environ.get("PANGENIE_TPU_PROFILE")
    if profile_dir:
        import jax

        with jax.profiler.trace(profile_dir):
            PairHMM.run_deferred([hmm for _, hmm in all_runs])
    else:
        PairHMM.run_deferred([hmm for _, hmm in all_runs])
    if all_runs:
        from .hmm import batch as hmm_batch

        # surface which implementation the forward-backward actually
        # used — a silently lost fast path must be visible in run logs
        _log(f"  forward-backward dispatch: {hmm_batch.last_dispatch}")
    for chromosome, hmm in all_runs:
        if chromosome not in results.result:
            results.result[chromosome] = hmm.move_genotyping_result()
        else:
            stored = results.result[chromosome]
            for i, likelihoods in enumerate(hmm.move_genotyping_result()):
                if likelihoods.likelihoods:
                    stored[i].combine(likelihoods)
        bulk = hmm.move_bulk_likelihoods()
        if bulk is not None:
            results.bulk[chromosome] = bulk
    # per-chromosome HMM runtimes (reference src/commands.cpp:179-184):
    # each run's host build/scatter time plus its column-weighted share
    # of the batched device dispatches
    for chromosome, hmm in all_runs:
        results.runtimes[chromosome] = (
            results.runtimes.get(chromosome, 0.0) + hmm.runtime
        )

    if dist.process_count() > 1:
        # gather partial per-chromosome results to the coordinator. The
        # partial whose first run has the globally smallest index becomes
        # the stored list (preserving the single-process move-first
        # semantics: the phasing run's haplotypes live in that partial);
        # the remaining partials' likelihoods are combined in (the
        # combine is a commutative sum, src/genotypingresult.cpp).
        gathered = dist.gather_objects(
            (results.result, results.runtimes, base_index, results.bulk)
        )
        results.result = {}
        results.bulk = {}
        runtimes = dict(results.runtimes)
        if gathered is not None:
            partials = sorted(
                (bases[chrom], chrom, part_result[chrom])
                for part_result, _, bases, _ in gathered
                for chrom in part_result
            )
            merged: Dict[str, List[GenotypeLikelihoods]] = {}
            for _, chrom, part in partials:
                if chrom not in merged:
                    merged[chrom] = part
                else:
                    stored = merged[chrom]
                    for i, likelihoods in enumerate(part):
                        if likelihoods.likelihoods:
                            stored[i].combine(likelihoods)
            results.result = merged
            # bulk channels exist only on single-subset runs, where each
            # chromosome's genotyping ran in exactly one process
            for _, _, _, part_bulk in gathered:
                results.bulk.update(part_bulk)
            runtimes = {}
            for _, part_runtimes, _, _ in gathered:
                for key, value in part_runtimes.items():
                    runtimes[key] = runtimes.get(key, 0.0) + value
        results.runtimes = runtimes
    results.runtimes["all"] = time.monotonic() - t

    if not only_phasing and not normalize_in_run:
        for chromosome in chromosomes:
            for g in results.result.get(chromosome, ()):
                g.normalize()

    if output_panel:
        for chromosome in chromosomes:
            for record in unique_kmers_list.unique_kmers[chromosome]:
                _, allele_ids = record.get_path_ids()
                chrom_to_sampled.setdefault(chromosome, []).append(
                    SampledPanel(allele_ids, record.size())
                )


def _write_outputs(
    chromosomes: List[str],
    results: Results,
    precomputed_prefix: str,
    outname: str,
    sample_name: str,
    only_genotyping: bool,
    only_phasing: bool,
    ignore_imputed: bool,
    output_panel: bool,
    chrom_to_sampled: Dict[str, List[SampledPanel]],
    serialize_output: bool,
) -> None:
    from .parallel import distributed as dist

    if not dist.is_coordinator():
        return  # results were gathered to the coordinator, which writes
    if serialize_output:
        _log("Serialize results ... ")
        _save(results, outname + "_genotyping.pkl")
        return
    _log("Write results to VCF ...")
    write_header = True
    for chromosome in chromosomes:
        graph: ChromosomeGraph = _load(
            f"{precomputed_prefix}_{chromosome}_Graph.pkl"
        )
        chrom_bulk = getattr(results, "bulk", {}).get(chromosome)
        if not only_phasing:
            graph.write_genotypes(
                outname + "_genotyping.vcf", results.result[chromosome],
                write_header, sample_name, ignore_imputed, chrom_bulk,
            )
        if not only_genotyping:
            graph.write_phasing(
                outname + "_phasing.vcf", results.result[chromosome],
                write_header, sample_name, ignore_imputed, chrom_bulk,
            )
        if output_panel:
            graph.write_sampled_panel(
                outname + "_panel.vcf", chrom_to_sampled[chromosome],
                write_header,
            )
        write_header = False


def run_genotype_command(
    precomputed_prefix: str,
    readfile: str,
    outname: str,
    sample_name: str = "sample",
    nr_jellyfish_threads: int = 1,
    nr_core_threads: int = 1,
    only_genotyping: bool = True,
    only_phasing: bool = False,
    effective_N: float = 0.00001,
    regularization: float = 0.01,
    count_only_graph: bool = True,
    ignore_imputed: bool = False,
    sampling_size: int = 0,
    panel_size: int = 0,
    recombrate: float = 1.26,
    output_panel: bool = False,
    sampling_effective_N: float = 0.01,
    allele_penalty: int = 5,
    serialize_output: bool = False,
    hash_size: int = 3_000_000_000,
) -> int:
    """PanGenie genotype from index (reference src/commands.cpp:730-1086)."""
    check_input_file(readfile)
    segment_file = precomputed_prefix + "_path_segments.fasta"
    check_input_file(segment_file)

    backend.platform()
    summary = PhaseSummary("PanGenie-genotype")
    results = Results()
    chrom_to_sampled: Dict[str, List[SampledPanel]] = {}

    archive = precomputed_prefix + "_UniqueKmersMap.pkl"
    check_input_file(archive)
    _log(f"Reading precomputed UniqueKmersMap from {archive} ...")
    unique_kmers_list: UniqueKmersMap = _load(archive)

    # std::map iteration order: chromosome names sorted
    chromosomes = sorted(unique_kmers_list.unique_kmers.keys())
    nr_paths = 0
    variants_read = 0
    for chromosome in chromosomes:
        records = unique_kmers_list.unique_kmers[chromosome]
        if records:
            nr_paths = records[0].get_nr_paths()
            variants_read += len(records)
    _log(f"Read {variants_read} variants from provided UniqueKmersMap archive.")
    if variants_read == 0:
        return 0
    if nr_paths == 0:
        raise RuntimeError("PanGenie-index: no haplotype paths given.")

    if panel_size == 0 and sampling_size == 0 and nr_paths > 100:
        panel_size = 15
        _log(
            "Number of haplotypes exceeds 100, enable haplotype sampling "
            "(15 haplotypes)"
        )

    summary.phase("reading UniqueKmersMap from disk")
    kmersize = unique_kmers_list.kmersize
    read_kmer_counts = _read_counter(
        readfile, segment_file, kmersize, count_only_graph,
        nr_jellyfish_threads, hash_size,
    )
    summary.phase("counting kmers in reads")

    kmer_abundance_peak = read_kmer_counts.compute_histogram(
        10000, count_only_graph, _coordinator_file(outname + "_histogram.histo")
    )
    _log(f"Computed kmer abundance peak: {kmer_abundance_peak}")

    probabilities = ProbabilityTable(
        kmer_abundance_peak // 4,
        kmer_abundance_peak * 4,
        2 * kmer_abundance_peak,
        regularization,
    )

    _log("Determine read k-mer counts for unique kmers ...")
    from concurrent.futures import ThreadPoolExecutor

    def _fill(chromosome):
        fill_read_kmercounts(
            chromosome, unique_kmers_list, read_kmer_counts, probabilities,
            precomputed_prefix, kmer_abundance_peak, 0, recombrate,
            sampling_effective_N, unique_kmers_list.add_reference,
            "", allele_penalty,
        )

    workers = max(1, min(nr_core_threads, len(chromosomes)))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(_fill, chromosomes))
    # haplotype sampling: all chromosomes batched into shared device
    # scans (one dispatch per greedy iteration, not per chromosome)
    if panel_size > 0 or output_panel:
        from .hmm.sampling import sample_panels_batched

        path_outputs = {}
        if output_panel:
            path_outputs = {
                chromosome: _coordinator_file(
                    f"{outname}_paths_{chromosome}.tsv"
                )
                for chromosome in chromosomes
            }
        sample_panels_batched(
            {c: unique_kmers_list.unique_kmers[c] for c in chromosomes},
            panel_size, recombrate, sampling_effective_N,
            unique_kmers_list.add_reference, path_outputs, allele_penalty,
        )

    summary.phase("updating unique kmers / sampling")

    _genotyping_block(
        chromosomes, unique_kmers_list, probabilities, results,
        only_genotyping, only_phasing, effective_N, recombrate,
        sampling_size, output_panel, chrom_to_sampled,
    )
    summary.phase("genotyping (HMM)")

    _write_outputs(
        chromosomes, results, precomputed_prefix, outname, sample_name,
        only_genotyping, only_phasing, ignore_imputed, output_panel,
        chrom_to_sampled, serialize_output,
    )
    summary.phase("writing output")
    summary.print_summary()
    return 0


# ---------------------------------------------------------------------------
# single command (index + genotype fused)
# ---------------------------------------------------------------------------


def run_single_command(
    readfile: str,
    reffile: str,
    vcffile: str,
    kmersize: int = 31,
    outname: str = "result",
    sample_name: str = "sample",
    nr_jellyfish_threads: int = 1,
    nr_core_threads: int = 1,
    only_genotyping: bool = True,
    only_phasing: bool = False,
    effective_N: float = 0.00001,
    regularization: float = 0.01,
    count_only_graph: bool = True,
    ignore_imputed: bool = False,
    add_reference: bool = True,
    sampling_size: int = 0,
    panel_size: int = 0,
    recombrate: float = 1.26,
    output_panel: bool = False,
    sampling_effective_N: float = 0.01,
    allele_penalty: int = 5,
    serialize_output: bool = False,
    hash_size: int = 3_000_000_000,
) -> int:
    """PanGenie single command (reference src/commands.cpp:224-590)."""
    check_input_file(reffile)
    check_input_file(vcffile)
    check_input_file(readfile)

    backend.platform()
    summary = PhaseSummary("PanGenie")
    results = Results()
    chrom_to_sampled: Dict[str, List[SampledPanel]] = {}
    segment_file = outname + "_path_segments.fasta"
    from .parallel import distributed as dist

    if not dist.is_coordinator():
        # every process rebuilds the (deterministic) panel in memory but
        # only the coordinator owns the shared-FS artifact names
        segment_file += f".proc{dist.process_index()}"

    unique_kmers_list = UniqueKmersMap(kmersize=kmersize, add_reference=add_reference)

    _log("Determine allele sequences ...")
    builder = PanelBuilder(vcffile, reffile, segment_file, kmersize, add_reference)
    nr_paths = builder.nr_of_paths()
    if panel_size == 0 and sampling_size == 0 and nr_paths > 100:
        panel_size = 15
        _log(
            "Number of haplotypes exceeds 100, enable haplotype sampling "
            "(15 haplotypes)"
        )
    chromosomes = builder.get_chromosomes()
    _log(f"Found {len(chromosomes)} chromosome(s) in the VCF.")
    summary.phase("reading input files")

    _log("Count kmers in graph ...")
    genomic_kmer_counts = ExactKmerCounter.count_file(
        segment_file, kmersize, n_threads=nr_jellyfish_threads,
        block_bases=int(min(max(hash_size // 64, 1 << 22), 1 << 28)),
    )
    summary.phase("counting kmers in graph")

    read_kmer_counts = _read_counter(
        readfile, segment_file, kmersize, count_only_graph,
        nr_jellyfish_threads, hash_size,
        prime_keys=(
            genomic_kmer_counts.keys if count_only_graph else None
        ),
    )
    summary.phase("counting kmers in reads")

    kmer_abundance_peak = read_kmer_counts.compute_histogram(
        10000, count_only_graph, _coordinator_file(outname + "_histogram.histo")
    )
    _log(f"Computed kmer abundance peak: {kmer_abundance_peak}")

    probabilities = ProbabilityTable(
        kmer_abundance_peak // 4,
        kmer_abundance_peak * 4,
        2 * kmer_abundance_peak,
        regularization,
    )

    # the selection phase's open-addressing lookup indexes build in the
    # background, overlapped with the Graph pickling below (each build
    # is seconds-scale at genome tables; get_abundances takes a lock,
    # so a slow build simply blocks the first lookup)
    import threading as _threading

    idx_threads = [
        _threading.Thread(target=c.prepare_lookup_index, daemon=True)
        for c in (genomic_kmer_counts, read_kmer_counts)
        if hasattr(c, "prepare_lookup_index")
    ]
    for t in idx_threads:
        t.start()

    # serialize graphs so they can be re-loaded for output writing after
    # streaming deletion (reference src/commands.cpp:343-347)
    _log("Serialize Graph objects ...")
    if dist.is_coordinator():
        for chromosome in chromosomes:
            _save(
                builder.graphs[chromosome], f"{outname}_{chromosome}_Graph.pkl"
            )
    summary.phase("writing Graph objects to disk")

    _log("Determine unique kmers ...")

    def _select_chromosome(chromosome: str):
        graph = builder.graphs[chromosome]
        computer = UniqueKmerComputer(
            genomic_kmer_counts, read_kmer_counts, graph, kmer_abundance_peak
        )
        return chromosome, computer.compute_unique_kmers(
            probabilities, delete_processed_variants=True
        )

    for t in idx_threads:
        t.join()
    # one selection task per chromosome over the -t worker pool
    # (reference src/commands.cpp:366-379); numpy sorts and the native
    # lookups release the GIL, so 2 host cores overlap well
    if nr_core_threads > 1 and len(chromosomes) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=nr_core_threads) as pool:
            for chromosome, records in pool.map(
                _select_chromosome, chromosomes
            ):
                unique_kmers_list.unique_kmers[chromosome] = records
    else:
        for chromosome in chromosomes:
            chromosome, records = _select_chromosome(chromosome)
            unique_kmers_list.unique_kmers[chromosome] = records
    summary.phase("determining unique kmers")

    if panel_size > 0 or output_panel:
        from .hmm.sampling import sample_panels_batched

        path_outputs = {}
        if output_panel:
            path_outputs = {
                chromosome: _coordinator_file(
                    f"{outname}_paths_{chromosome}.tsv"
                )
                for chromosome in chromosomes
            }
        sample_panels_batched(
            {c: unique_kmers_list.unique_kmers[c] for c in chromosomes},
            panel_size, recombrate, sampling_effective_N, add_reference,
            path_outputs, allele_penalty,
        )
    summary.phase("sampling haplotypes")

    _genotyping_block(
        chromosomes, unique_kmers_list, probabilities, results,
        only_genotyping, only_phasing, effective_N, recombrate,
        sampling_size, output_panel, chrom_to_sampled,
    )
    summary.phase("genotyping (HMM)")

    _write_outputs(
        chromosomes, results, outname, outname, sample_name,
        only_genotyping, only_phasing, ignore_imputed, output_panel,
        chrom_to_sampled, serialize_output,
    )
    summary.phase("writing output")
    summary.print_summary()
    return 0


# ---------------------------------------------------------------------------
# vcf (serialized results -> VCF)
# ---------------------------------------------------------------------------


def run_vcf_command(
    precomputed_prefix: str,
    results_name: str,
    outname: str,
    sample_name: str = "sample",
    only_genotyping: bool = True,
    only_phasing: bool = False,
    ignore_imputed: bool = False,
) -> int:
    """PanGenie-vcf (reference src/commands.cpp:1088-1154)."""
    _log(f"Reading serialized genotyping results from {results_name}")
    results: Results = _load(results_name)

    _log("Write results to VCF ...")
    write_header = True
    for chromosome in sorted(results.result.keys()):
        graph: ChromosomeGraph = _load(
            f"{precomputed_prefix}_{chromosome}_Graph.pkl"
        )
        chrom_bulk = getattr(results, "bulk", {}).get(chromosome)
        if not only_phasing:
            graph.write_genotypes(
                outname + "_genotyping.vcf", results.result[chromosome],
                write_header, sample_name, ignore_imputed, chrom_bulk,
            )
        if not only_genotyping:
            graph.write_phasing(
                outname + "_phasing.vcf", results.result[chromosome],
                write_header, sample_name, ignore_imputed, chrom_bulk,
            )
        write_header = False
    return 0


# ---------------------------------------------------------------------------
# sampling (standalone panel reduction -> panel VCF)
# ---------------------------------------------------------------------------


def run_sampling(
    precomputed_prefix: str,
    readfile: str,
    outname: str,
    nr_jellyfish_threads: int = 1,
    nr_core_threads: int = 1,
    regularization: float = 0.01,
    count_only_graph: bool = True,
    panel_size: int = 0,
    recombrate: float = 1.26,
    sampling_effective_N: float = 0.01,
    allele_penalty: int = 5,
    hash_size: int = 3_000_000_000,
) -> int:
    """PanGenie-sampling (reference src/commands.cpp:1156-1360)."""
    check_input_file(readfile)
    segment_file = precomputed_prefix + "_path_segments.fasta"
    check_input_file(segment_file)

    chrom_to_sampled: Dict[str, List[SampledPanel]] = {}

    archive = precomputed_prefix + "_UniqueKmersMap.pkl"
    check_input_file(archive)
    unique_kmers_list: UniqueKmersMap = _load(archive)
    chromosomes = sorted(unique_kmers_list.unique_kmers.keys())

    variants_read = sum(
        len(unique_kmers_list.unique_kmers[c]) for c in chromosomes
    )
    if variants_read == 0:
        return 0

    kmersize = unique_kmers_list.kmersize
    read_kmer_counts = _read_counter(
        readfile, segment_file, kmersize, count_only_graph,
        nr_jellyfish_threads, hash_size,
    )
    kmer_abundance_peak = read_kmer_counts.compute_histogram(
        10000, count_only_graph, _coordinator_file(outname + "_histogram.histo")
    )
    probabilities = ProbabilityTable(
        kmer_abundance_peak // 4,
        kmer_abundance_peak * 4,
        2 * kmer_abundance_peak,
        regularization,
    )

    # read-count fill across chromosomes on the thread pool, then ONE
    # batched device sampling pass (same structure as the genotype
    # command; the old per-chromosome HaplotypeSampler loop ran the
    # greedy scans sequentially and ignored nr_core_threads)
    from concurrent.futures import ThreadPoolExecutor

    from .hmm.sampling import sample_panels_batched

    def _fill(chromosome):
        fill_read_kmercounts(
            chromosome, unique_kmers_list, read_kmer_counts, probabilities,
            precomputed_prefix, kmer_abundance_peak, 0, recombrate,
            sampling_effective_N, unique_kmers_list.add_reference,
            "", allele_penalty,
        )

    workers = max(1, min(nr_core_threads, len(chromosomes)))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(_fill, chromosomes))
    # sampling always writes the paths TSVs (src/commands.cpp:1285)
    sample_panels_batched(
        {c: unique_kmers_list.unique_kmers[c] for c in chromosomes},
        panel_size, recombrate, sampling_effective_N,
        unique_kmers_list.add_reference,
        {c: f"{outname}_paths_{c}.tsv" for c in chromosomes},
        allele_penalty,
    )
    for chromosome in chromosomes:
        for record in unique_kmers_list.unique_kmers[chromosome]:
            _, allele_ids = record.get_path_ids()
            chrom_to_sampled.setdefault(chromosome, []).append(
                SampledPanel(allele_ids, record.size())
            )

    _log("Write sampled panel to VCF ...")
    write_header = True
    for chromosome in chromosomes:
        graph: ChromosomeGraph = _load(
            f"{precomputed_prefix}_{chromosome}_Graph.pkl"
        )
        graph.write_sampled_panel(
            outname + "_panel.vcf", chrom_to_sampled[chromosome], write_header
        )
        write_header = False
    return 0


# ---------------------------------------------------------------------------
# analyze-uk (debug: print unique-kmer matrices)
# ---------------------------------------------------------------------------


def run_analyze_uk(precomputed_uk: str) -> int:
    """Print the kmer x allele incidence matrix of every variant
    (reference src/analyze-uk.cpp: one line per allele,
    chromosome / position / 0-1 kmer bitstring)."""
    unique_kmers_list: UniqueKmersMap = _load(precomputed_uk)
    try:
        for chromosome in sorted(unique_kmers_list.unique_kmers.keys()):
            for record in unique_kmers_list.unique_kmers[chromosome]:
                for allele in record.get_allele_ids():
                    bits = "".join(
                        "1" if record.kmer_on_allele(ki, allele) else "0"
                        for ki in range(record.size())
                    )
                    print(
                        f"{chromosome}\t{record.get_variant_position()}\t{bits}"
                    )
    except BrokenPipeError:
        # downstream pipe (e.g. `| head`) closed: standard unix-tool exit
        import os as _os

        _os.dup2(_os.open(_os.devnull, _os.O_WRONLY), sys.stdout.fileno())
    return 0

"""pangenie_tpu: a JAX pangenome genotyper for one or more GPUs.

A from-scratch JAX/XLA/Pallas re-design of the PanGenie short-read
genotyper (pangenome-based k-mer genotyping with a Li-Stephens pair HMM).

Layer map (mirrors capabilities of the reference C++ implementation,
re-architected for an accelerator):

- ``io``      : FASTA / VCF parsing and index serialization (host side)
- ``panel``   : pangenome graph construction (bubble clustering / allele
                merging), VCF output writers
- ``kmers``   : canonical k-mer counting (sorted-table engine with a
                numpy/C++ host path and a JAX device path), histogram /
                coverage estimation, unique-kmer selection
- ``model``   : copy-number probability model (geometric + Poisson with
                regularization), emission factorization
- ``hmm``     : batched forward/backward + Viterbi pair-HMM scans and the
                integer min-plus haplotype-sampling DP
- ``parallel``: device meshes, sharding of (chromosome-batch, path-subset)
                work over the local devices
- ``cli``     : `pangenie-tpu index|genotype|vcf|sample` entry points
"""

__version__ = "0.1.0"

import jax as _jax

# The reference-parity genotyping path accumulates per-column
# likelihoods spanning ~1e-60 .. 1 in float64; the accelerator path
# selects float32 explicitly (backend.hmm_dtype).
_jax.config.update("jax_enable_x64", True)

from . import backend as _backend  # noqa: E402

_backend.configure()

"""Batched forward-backward dispatch.

Single entry point for running a [B, N, ...] batch of independent
forward-backward problems on one device; the production genotyping
path, the bench, and the sharded multi-device step all go through here
so the GPU kernel (hmm/pallas_fb.py) and the portable XLA scan are
chosen in one place.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import backend
from .forward_backward import ColumnArrays, forward_backward

# The kernel keeps each program's [PP, PP] f32 state tensors (PP = P
# rounded up to a power of two) in registers, spread over at most 16
# warps (512 threads): at PP = 128 that is 32 registers a thread per
# tensor, and a step keeps a handful of such tensors live, within the
# 255 registers a thread may have. PP = 256 would need 128 per tensor.
# On an H100, P = 128 compiles and runs 3.7x faster than the XLA scan.
KERNEL_MAX_PATHS = 128
# the backward kernel's in-kernel collapse makes one [PP, PP] reduction
# per allele and column. On an H100 (B=16, N=2048, P=32) the kernel ran
# 6.0x the scan at A=16, 3.3x at A=32 and 1.3x at A=64 (with a 9 s
# compile); wider bubbles go to the scan
KERNEL_MAX_ALLELES = 32
# share of the free device memory the kernel's buffers may take
_MEMORY_SHARE = 0.8


def _kernel_bytes(B: int, N: int, P: int, A: int) -> int:
    """Device bytes of the kernel's intermediates: the forward pass's
    alphas [B, N, PP, PP] plus the inputs it restages."""
    from .pallas_fb import _pow2

    PP = _pow2(P)
    return 4 * B * N * (PP * PP + PP + A * A + 8)


def use_kernel(columns: ColumnArrays) -> bool:
    """True when the Triton forward-backward kernel handles this batch:
    float32 columns on an accelerator, P and A within the kernel's
    caps, and its buffers within the free device memory."""
    if columns.lp.dtype != jnp.float32:
        return False
    B, N, P = columns.alleles.shape
    A = columns.incidence.shape[3]
    if N == 0 or P > KERNEL_MAX_PATHS or A > KERNEL_MAX_ALLELES:
        return False
    if not backend.is_accelerator():
        return False
    budget = _MEMORY_SHARE * backend.device_bytes_free()
    return _kernel_bytes(B, N, P, A) <= budget


# which implementation the most recent forward_backward_batch call
# chose: "pallas_triton" | "xla_scan". Production logs it per phase so a
# silently lost fast path is visible; chip_smoke.py prints it.
last_dispatch: str = "none"
# path counts already warned about (see _warn_if_paths_block_kernel)
_logged: set = set()


def forward_backward_batch(columns: ColumnArrays):
    """Run B independent forward-backward scans.

    Args:
      columns: ColumnArrays with leading dims [B, N, ...].

    Returns:
      (posteriors [B, N, A, A], log_correction [B, N]) — see
      :func:`forward_backward`.
    """
    import jax

    global last_dispatch
    if use_kernel(columns):
        from . import pallas_fb

        last_dispatch = "pallas_triton"
        return pallas_fb.forward_backward_batch_pallas(columns)
    _warn_if_paths_block_kernel(columns)
    last_dispatch = "xla_scan"
    return jax.vmap(forward_backward)(columns)


def _warn_if_paths_block_kernel(columns: ColumnArrays) -> None:
    """A float32 batch on an accelerator that only its path count keeps
    off the kernel runs the slower XLA scan: say so once per P. The fix
    is haplotype sampling or a path subset (-a), not a bigger cap."""
    B, N, P = columns.alleles.shape
    if P <= KERNEL_MAX_PATHS or columns.lp.dtype != jnp.float32:
        return
    if columns.incidence.shape[3] > KERNEL_MAX_ALLELES:
        return
    if not backend.is_accelerator():
        return
    key = ("warn_paths", P)
    if key in _logged:
        return
    _logged.add(key)
    import sys

    print(
        f"  WARNING: {P} paths exceeds the HMM kernel's cap of "
        f"{KERNEL_MAX_PATHS}; running the slower XLA scan. Use haplotype "
        f"sampling or a path subset (-a) of <= {KERNEL_MAX_PATHS} paths "
        "to stay on the kernel.",
        file=sys.stderr,
    )

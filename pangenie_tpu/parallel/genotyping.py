"""Sharded batched genotyping step.

The genotyping workload is a grid of independent HMM runs over
(path-subset s, work-item b) — work items are chromosome blocks padded
to common (N columns, P paths, K kmers, A alleles). Per variant the raw
(unnormalized) allele-pair likelihoods of all subsets are SUMMED before
the final normalization (reference src/commands.cpp:155-185, 980-988);
under a (subset, batch) mesh that merge is a ``psum`` over the subset
axis, replacing the reference's result mutex.

Layout:
  inputs  ColumnArrays with leading dims [S, B, ...] sharded
          P('subset', 'batch') — every device holds S/s_mesh × B/b_mesh
          HMM problem instances in its memory,
  compute vmapped forward-backward scans (per-device batch),
  output  [S?, B, N, A, A] posteriors; combined over 'subset' via psum,
          replicated on the subset axis, sharded over 'batch'.
"""

from __future__ import annotations

import sys
from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..hmm.batch import forward_backward_batch
from ..hmm.forward_backward import ColumnArrays


def _fb_batch(columns: ColumnArrays):
    """Batched forward_backward over one leading batch dim (the GPU
    kernel when eligible, vmapped XLA scan otherwise)."""
    return forward_backward_batch(columns)


def sharded_forward_backward(mesh: Mesh, columns: ColumnArrays):
    """Run the [S, B] grid of forward-backward problems on the mesh.

    Args:
      mesh: a Mesh with ('subset', 'batch') axes.
      columns: ColumnArrays whose leaves have leading dims [S, B, ...];
        S and B must be divisible by the mesh axis sizes.

    Returns:
      posteriors [B, N, A, A]: per-work-item allele-pair likelihood
        grids (emission-rescaled), summed over path subsets,
      log_correction [B, N]: per-column log factors restoring the
        reference's raw likelihood scale (see forward_backward).
    """
    in_spec = jax.tree.map(lambda _: P("subset", "batch"), columns)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(in_spec,),
        out_specs=(P("batch"), P("batch")),
        check_vma=False,
    )
    def step(cols: ColumnArrays):
        # local block [S_loc, B_loc, ...]: flatten, vmap, unflatten
        s_loc, b_loc = cols.alleles.shape[:2]
        flat = jax.tree.map(
            lambda x: x.reshape((s_loc * b_loc,) + x.shape[2:]), cols
        )
        posts, corr = _fb_batch(flat)  # [S*B, N, A, A], [S*B, N]
        posts = posts.reshape((s_loc, b_loc) + posts.shape[1:])
        corr = corr.reshape((s_loc, b_loc) + corr.shape[1:])
        # the log-correction is subset-independent (scale depends only
        # on the column's kmer probabilities), so summing SCALED raw
        # posteriors across subsets is exact; host code applies
        # exp(corr) once after gathering
        local = jnp.sum(posts, axis=0)  # combine local subsets
        return jax.lax.psum(local, "subset"), corr[0]

    return step(columns)


def shard_columns(mesh: Mesh, columns: ColumnArrays) -> ColumnArrays:
    """Place [S, B, ...] column arrays onto the mesh."""
    sharding = NamedSharding(mesh, P("subset", "batch"))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), columns)


def sharded_viterbi(mesh: Mesh, columns: ColumnArrays, uniform: bool = False):
    """Run a [1, B] grid of Viterbi problems sharded over 'batch'.

    Phasing runs use a single path subset (S = 1); the batch dim (the
    chromosome grid) shards over local chips exactly like the
    forward-backward grid.

    Returns states [B, N] (the max-plus backtrace state per column).
    """
    from ..hmm.viterbi import viterbi

    in_spec = jax.tree.map(lambda _: P("subset", "batch"), columns)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(in_spec,),
        out_specs=P("batch"),
        check_vma=False,
    )
    def step(cols: ColumnArrays):
        s_loc, b_loc = cols.alleles.shape[:2]
        flat = jax.tree.map(
            lambda x: x.reshape((s_loc * b_loc,) + x.shape[2:]), cols
        )
        states = jax.vmap(lambda c: viterbi(c, uniform=uniform))(flat)
        return states.reshape((s_loc, b_loc) + states.shape[1:])[0]

    return step(columns)


def run_grid_local_sharded(members_cols, run_g: bool, run_p: bool,
                           uniform: bool, n_devices: int):
    """Execute a stacked [B, ...] HMM grid across the local devices.

    The production analogue of the reference's thread pool over the
    (chromosome x subset) grid (src/commands.cpp:955-978): work items
    shard over a flat ('subset'=1, 'batch'=n) mesh of the process's
    LOCAL devices; each device runs its share through the same batched
    forward-backward/viterbi entry points, so results are bit-identical
    to the single-device path (no cross-work-item math happens — the
    subset axis has extent 1 and its psum is an identity).

    Args:
      members_cols: list of B per-work-item ColumnArrays (same shapes).
      n_devices: number of local devices to use (>= 2).

    Returns (posteriors [B, N, A, A] | None, log_corr [B, N] | None,
             states [B, N] | None) as numpy arrays trimmed to B.
    """
    import numpy as np

    B = len(members_cols)
    n_use = min(n_devices, B)
    Bp = (B + n_use - 1) // n_use * n_use
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *members_cols)
    if Bp != B:
        stacked = jax.tree.map(
            lambda x: jnp.concatenate(
                [x, jnp.repeat(x[:1], Bp - B, axis=0)]
            ),
            stacked,
        )
    mesh = Mesh(
        np.array(jax.devices()[:n_use]).reshape(1, n_use),
        ("subset", "batch"),
    )
    print(f"  HMM grid of {B} items sharded over {n_use} devices",
          file=sys.stderr)
    cols2 = shard_columns(mesh, jax.tree.map(lambda x: x[None], stacked))
    posts = corr = states = None
    if run_g:
        p, c = sharded_forward_backward(mesh, cols2)
        posts, corr = np.asarray(p)[:B], np.asarray(c)[:B]
    if run_p:
        states = np.asarray(sharded_viterbi(mesh, cols2, uniform))[:B]
    return posts, corr, states

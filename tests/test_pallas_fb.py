"""Triton forward-backward kernel vs the XLA scan oracle.

Runs the GPU kernel in Pallas interpret mode on the CPU and checks it
against jax.vmap(forward_backward) on the same float32 inputs. Shapes
exercise the padding paths: P and A not powers of two (padded states
masked out of every sum), columns after is_last (padding), and an
all-zero column (the uniform underflow fallback). The dispatch tests
pin which implementation a batch gets on the CPU and on a GPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pangenie_tpu.hmm import batch as hb
from pangenie_tpu.hmm import pallas_fb
from pangenie_tpu.hmm.forward_backward import forward_backward
from pangenie_tpu.hmm.pallas_fb import forward_backward_batch_pallas
from pangenie_tpu.utils.synthetic import synthetic_columns


def _f32_device(cols):
    leaves = []
    for x in cols:
        x = np.asarray(x)
        if x.dtype == np.float64:
            x = x.astype(np.float32)
        leaves.append(jnp.asarray(x))
    return type(cols)(*leaves)


def _compare(cols, rtol=2e-4, atol=1e-7, n_real=None):
    d = _f32_device(cols)
    ref_p, ref_c = jax.jit(jax.vmap(forward_backward))(d)
    pal_p, pal_c = forward_backward_batch_pallas(d, interpret=True)
    assert pal_p.shape == ref_p.shape and pal_c.shape == ref_c.shape
    n = n_real or pal_p.shape[1]
    np.testing.assert_allclose(
        np.asarray(pal_p)[:, :n], np.asarray(ref_p)[:, :n],
        rtol=rtol, atol=atol,
    )
    np.testing.assert_allclose(np.asarray(pal_c), np.asarray(ref_c))


def _with_zero_column(cols, n):
    """Column n: every kmer probability zero (emission underflows to
    zero, so the normalisation falls back to uniform)."""
    lp = np.asarray(cols.lp).copy()
    lp[:, n] = -np.inf
    az = np.asarray(cols.all_zeros).copy()
    az[:, n] = True
    return cols._replace(lp=lp, all_zeros=az)


def _with_padded_tail(cols, n_real):
    """Columns from n_real on are padding, as genotyping.py builds
    them: all_zeros (emission 1) and stay-only transitions."""
    is_last = np.zeros_like(np.asarray(cols.is_last))
    is_last[..., n_real - 1] = True
    az = np.asarray(cols.all_zeros).copy()
    az[:, n_real:] = True
    trans = np.asarray(cols.trans).copy()
    trans[:, n_real:] = [1.0, 0.0, 0.0]
    return cols._replace(is_last=is_last, all_zeros=az, trans=trans)


@pytest.mark.parametrize("B,N,P,K", [(3, 24, 8, 8), (2, 17, 16, 4)])
def test_pallas_matches_xla_scan(B, N, P, K):
    cols = synthetic_columns(
        n_columns=N, n_paths=P, n_kmers=K, batch_dims=(B,),
        dtype=np.float32,
    )
    _compare(cols)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("P", [4, 15, 32])
@pytest.mark.parametrize("A", [2, 4, 8])
def test_kernel_grid_with_zero_column_and_padded_tail(A, P, B):
    N = 10
    cols = synthetic_columns(
        n_columns=N, n_paths=P, n_kmers=max(4, A), n_alleles=A,
        batch_dims=(B,), dtype=np.float32, seed=A * 100 + P,
    )
    cols = _with_padded_tail(_with_zero_column(cols, 3), N - 3)
    _compare(cols, n_real=N - 3)


@pytest.mark.parametrize("A", [2, 8])
def test_diploid_counts_keep_f32_near_f64(A):
    """With read counts drawn from a diploid genotype, the f32 scan's
    normalised posteriors stay within chip_smoke.py's 1e-4 of f64 at
    A=8 too (cn=1 counts at A > 2 underflow f32 instead)."""
    host = synthetic_columns(
        n_columns=64, n_paths=8, n_kmers=16, n_alleles=A,
        batch_dims=(2,), dtype=np.float64, seed=A, diploid=True,
    )
    scan = jax.jit(jax.vmap(forward_backward))
    p64 = np.asarray(scan(type(host)(*[jnp.asarray(x) for x in host]))[0])
    p32 = np.asarray(scan(_f32_device(host))[0], np.float64)

    def norm(p):
        return p / p.sum(axis=(-1, -2), keepdims=True)

    assert np.max(np.abs(norm(p32) - norm(p64))) < 1e-4


def test_kernel_wide_bubbles():
    """A=16 and A=32 (above the old 8-allele cap) on the kernel."""
    for A in (16, 32):
        cols = synthetic_columns(
            n_columns=6, n_paths=8, n_kmers=A, n_alleles=A,
            batch_dims=(2,), dtype=np.float32, seed=A, diploid=True,
        )
        _compare(cols)


def test_pallas_multiallelic_and_padding():
    cols = synthetic_columns(
        n_columns=10, n_paths=8, n_kmers=6, n_alleles=3, batch_dims=(2,),
        dtype=np.float32,
    )
    _compare(cols)


def test_pallas_padded_tail_columns():
    """Columns after is_last are padding; real outputs must not change."""
    cols = synthetic_columns(
        n_columns=12, n_paths=8, n_kmers=4, batch_dims=(2,),
        dtype=np.float32,
    )
    # mark column 7 as the last real column; the rest is pass-through
    is_last = np.zeros_like(np.asarray(cols.is_last))
    is_last[..., 7] = True
    _compare(cols._replace(is_last=is_last), n_real=8)


def test_pallas_all_zero_column_uniform_fallback():
    cols = synthetic_columns(
        n_columns=6, n_paths=4, n_kmers=4, batch_dims=(1,),
        dtype=np.float32,
    )
    _compare(_with_zero_column(cols, 2))


def test_kernel_pads_states_to_powers_of_two():
    """P=5 pads to 8 states and A=3 to 4 allele slots inside the
    kernel; the wrapper returns the unpadded [B, N, A, A]."""
    assert (pallas_fb._pow2(5), pallas_fb._pow2(3)) == (8, 4)
    assert pallas_fb.num_warps(32) == 2
    assert 1 <= pallas_fb.num_warps(4) <= pallas_fb.num_warps(64) <= 16
    cols = _f32_device(synthetic_columns(
        n_columns=5, n_paths=5, n_kmers=4, n_alleles=3, batch_dims=(2,),
        dtype=np.float32,
    ))
    posts, corr = forward_backward_batch_pallas(cols, interpret=True)
    assert posts.shape == (2, 5, 3, 3) and corr.shape == (2, 5)
    assert posts.dtype == jnp.float32


def test_batch_dispatch_cpu_falls_back_to_scan():
    cols = synthetic_columns(
        n_columns=8, n_paths=4, n_kmers=4, batch_dims=(2,),
        dtype=np.float32,
    )
    d = _f32_device(cols)
    assert not hb.use_kernel(d)  # CPU backend in tests
    posts, corr = hb.forward_backward_batch(d)
    assert hb.last_dispatch == "xla_scan"
    ref_p, ref_c = jax.jit(jax.vmap(forward_backward))(d)
    np.testing.assert_allclose(np.asarray(posts), np.asarray(ref_p))
    np.testing.assert_allclose(np.asarray(corr), np.asarray(ref_c))


def _as_gpu(monkeypatch, free_bytes=80 << 30):
    from pangenie_tpu import backend

    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    monkeypatch.setattr(backend, "device_bytes_free", lambda: free_bytes)
    # no card here: the kernel the dispatcher picks runs interpreted
    monkeypatch.setattr(
        pallas_fb, "forward_backward_batch_pallas",
        functools.partial(forward_backward_batch_pallas, interpret=True),
    )


def test_batch_dispatch_gpu_picks_kernel(monkeypatch):
    _as_gpu(monkeypatch)
    d = _f32_device(synthetic_columns(
        n_columns=8, n_paths=6, n_kmers=4, batch_dims=(2,),
        dtype=np.float32,
    ))
    assert hb.use_kernel(d)
    posts, _ = hb.forward_backward_batch(d)
    assert hb.last_dispatch == "pallas_triton"
    ref_p, _ = jax.jit(jax.vmap(forward_backward))(d)
    np.testing.assert_allclose(
        np.asarray(posts), np.asarray(ref_p), rtol=2e-4, atol=1e-7
    )


@pytest.mark.parametrize("case", ["float64", "alleles", "memory"])
def test_batch_dispatch_gpu_scan_cases(monkeypatch, case):
    """On a GPU the scan still takes f64 batches, bubbles wider than
    the kernel's allele cap, and batches whose buffers exceed the free
    device memory."""
    _as_gpu(monkeypatch, free_bytes=1 << 10 if case == "memory" else 80 << 30)
    A = hb.KERNEL_MAX_ALLELES * 2 if case == "alleles" else 2
    dtype = np.float64 if case == "float64" else np.float32
    cols = synthetic_columns(
        n_columns=8, n_paths=4, n_kmers=A, n_alleles=A, batch_dims=(1,),
        dtype=dtype,
    )
    d = type(cols)(*[jnp.asarray(x) for x in cols])
    assert not hb.use_kernel(d)
    hb.forward_backward_batch(d)
    assert hb.last_dispatch == "xla_scan"


def test_p_above_kernel_cap_warns(monkeypatch, capsys):
    """A path count above the kernel's P cap falls back to the scan
    LOUDLY: the dispatch choice would otherwise be invisible."""
    _as_gpu(monkeypatch)
    P = hb.KERNEL_MAX_PATHS + 4
    cols = synthetic_columns(
        n_columns=16, n_paths=P, n_kmers=4, batch_dims=(1,),
        dtype=jnp.float32, seed=0,
    )
    cols = type(cols)(*[jnp.asarray(x) for x in cols])
    hb._logged.discard(("warn_paths", P))
    hb.forward_backward_batch(cols)
    assert hb.last_dispatch == "xla_scan"
    err = capsys.readouterr().err
    assert "exceeds the HMM kernel's cap" in err
    # once per shape only
    hb.forward_backward_batch(cols)
    assert "cap" not in capsys.readouterr().err

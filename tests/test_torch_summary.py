"""The port's movie summary (plain version of kernel K1) against the JAX
package's ``movie_summary`` (XLA scan) and ``movie_summary_pallas`` (the TPU
kernel, in interpret mode), on the cases of ``tests/test_summary.py``.

Tolerances:
- max: exact everywhere.
- integer mean: bitwise equal to the Pallas kernel, which divides the exact
  sum by T; within 1 ulp of the jitted scan, because XLA rewrites the
  division by the constant T into a multiplication by 1/T.
- float32 mean: rtol=1e-6, atol=1e-6. The JAX sums accumulate in float32,
  the port's in float64, and near-zero means lose relative digits.
"""

import importlib
import subprocess

import numpy as np
import pytest
import torch

from deepcalcium_tpu.ops import summary as jsummary
from deepcalcium_torch.ops import summary as tsummary

torch.set_num_threads(1)


# (name, shape, dtype, low, high, pallas chunk, pallas block_h); float cases
# draw standard normals shifted by ``low``.
CASES = [
    ("oracle_37x24x40", (37, 24, 40), np.int16, -100, 3000, 8, 8),
    ("float_nondivisible_t", (10, 8, 128), np.float32, -5.0, None, 4, 8),
    ("all_negative_int", (7, 8, 130), np.int16, -5000, -10, 4, 8),
    ("prime_t_ragged_hw", (31, 19, 137), np.int16, -100, 3000, None, 8),
    ("multirow_blocks", (12, 40, 128), np.int16, 0, 2000, 6, 8),
    ("float_centered", (16, 8, 16), np.float32, 0.0, None, 4, 8),
    ("uint16_wide", (9, 16, 24), np.uint16, 0, 65536, 4, 8),
]


def _movie(case):
    _, shape, dtype, lo, hi, _, _ = case
    rng = np.random.default_rng(865 + CASES.index(case))
    if np.dtype(dtype).kind == "f":
        return (rng.standard_normal(shape) + lo).astype(dtype)
    return rng.integers(lo, hi, shape).astype(dtype)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_summary_matches_jax(case):
    movie = _movie(case)
    mean, mx = tsummary.movie_summary(torch.from_numpy(movie), chunk=5)
    mean, mx = mean.numpy(), mx.numpy()
    assert mean.dtype == np.float32 and mx.dtype == movie.dtype

    jmean, jmx = map(np.asarray, jsummary.movie_summary(movie, chunk=8))
    pmean, pmx = map(np.asarray, jsummary.movie_summary_pallas(
        movie, chunk=case[5], block_h=case[6], interpret=True))
    np.testing.assert_array_equal(mx, jmx)
    np.testing.assert_array_equal(mx.astype(np.float32), pmx)
    if movie.dtype.kind in "iu":
        np.testing.assert_array_equal(mean, pmean)
        np.testing.assert_array_max_ulp(mean, jmean, maxulp=1)
        np.testing.assert_array_equal(
            mean, movie.astype(np.int64).sum(0).astype(np.float32)
            / np.float32(movie.shape[0]))
    else:
        np.testing.assert_allclose(mean, jmean, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(mean, pmean, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk", [1, 4, 64])
def test_summary_chunk_invariance(chunk):
    """Integer sums are exact, so any chunking gives the same bits."""
    movie = _movie(CASES[0])
    ref = tsummary.movie_summary(torch.from_numpy(movie), chunk=37)
    out = tsummary.movie_summary(torch.from_numpy(movie), chunk=chunk)
    assert torch.equal(ref[0], out[0]) and torch.equal(ref[1], out[1])


def test_summary_exact_past_float32_integer_range():
    """Sums above 2**24 stay exact (int64), unlike a float32 running sum."""
    movie = np.full((600, 2, 3), 32767, np.int16)
    movie[::2] = 32766
    mean, mx = tsummary.movie_summary(torch.from_numpy(movie))
    exact = np.float32(movie.astype(np.int64).sum(0) / 600)
    np.testing.assert_array_equal(mean.numpy(), exact)
    assert (mx.numpy() == 32767).all()


def test_summary_fast_cpu_takes_plain_path():
    movie = _movie(CASES[3])
    before = tsummary.movie_summary_cuda.launches
    mean, mx = tsummary.movie_summary_fast(torch.from_numpy(movie))
    assert tsummary.movie_summary_cuda.launches == before
    assert mx.dtype == torch.float32  # the Pallas path's contract
    ref_mean, ref_mx = tsummary.movie_summary(torch.from_numpy(movie))
    assert torch.equal(mean, ref_mean)
    assert torch.equal(mx, ref_mx.to(torch.float32))


def test_kernel_module_import_needs_no_nvcc(monkeypatch):
    """Importing the kernel modules and running on the CPU neither needs
    nor runs nvcc; the CUDA wrapper refuses a CPU tensor before building."""
    from deepcalcium_torch.ops import _build

    def no_subprocess(*a, **k):
        raise AssertionError(f"subprocess run during import: {a}")

    monkeypatch.setattr(subprocess, "run", no_subprocess)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    importlib.reload(_build)
    mod = importlib.reload(tsummary)
    mean, _ = mod.movie_summary_fast(torch.zeros((3, 4, 5), dtype=torch.int16))
    assert mean.shape == (4, 5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mod.movie_summary_cuda(torch.zeros((3, 4, 5), dtype=torch.int16))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_summary_rejects_bad_shapes():
    with pytest.raises(ValueError, match=r"\(T, H, W\)"):
        tsummary.movie_summary(torch.zeros((4, 5)))
    with pytest.raises(ValueError, match="empty"):
        tsummary.movie_summary(torch.zeros((0, 4, 5)))

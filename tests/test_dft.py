"""Unit tests for the matmul-DFT primitives (ops/dft.py).

These check the MATH (matrices, mirroring, Hermitian handling, the
Wiener-Khinchin autocorrelation identity) on the CPU backend; each
engine's dot algorithm on the GPU is checked by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp

from jeicyboodsp_tpu.ops import dft


def test_rdft_matches_numpy(rng):
    x = rng.normal(0, 100, (5, 1024)).astype(np.float32)
    re, im = dft.rdft(jnp.asarray(x))
    want = np.fft.rfft(x.astype(np.float64))
    got = np.asarray(re) + 1j * np.asarray(im)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_irdft_roundtrip(rng):
    x = rng.normal(0, 100, (3, 512)).astype(np.float32)
    re, im = dft.rdft(jnp.asarray(x))
    y = np.asarray(dft.irdft(re, im, 512))
    assert np.abs(y - x).max() < 1e-3


def test_full_from_half_is_fft(rng):
    x = rng.normal(0, 10, (2, 256)).astype(np.float32)
    fr, fi = dft.cdft_of_real_full(jnp.asarray(x))
    want = np.fft.fft(x.astype(np.float64))
    got = np.asarray(fr) + 1j * np.asarray(fi)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_icdft_real_non_hermitian(rng):
    """The full-bin inverse must reproduce ifft(X).real for spectra WITHOUT
    Hermitian symmetry (the MVDR quirk-merged case)."""
    re = rng.normal(0, 10, (2, 256)).astype(np.float32)
    im = rng.normal(0, 10, (2, 256)).astype(np.float32)
    want = np.fft.ifft(re.astype(np.float64) + 1j * im.astype(np.float64)).real
    got = np.asarray(dft.icdft_real(jnp.asarray(re), jnp.asarray(im)))
    assert np.abs(got - want).max() < 1e-4


def test_autocorr_identity(rng):
    """Wiener-Khinchin: circular autocorrelation from the half-bin power."""
    x = rng.normal(0, 5, (3, 128)).astype(np.float32)
    X = np.fft.fft(x.astype(np.float64))
    want = np.fft.ifft(np.abs(X) ** 2).real[:, :64]
    re, im = dft.rdft(jnp.asarray(x))
    got = np.asarray(
        dft.autocorr_from_half_power(re**2 + im**2, 128, 64)
    )
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_linear_autocorr_via_zero_padding(rng):
    """Zero-padding to 2n makes the circular autocorrelation linear -- the
    identity behind the pitch method-3 fast path."""
    n = 64
    x = rng.normal(0, 5, (1, n)).astype(np.float32)
    xp = np.concatenate([x, np.zeros_like(x)], axis=1)
    re, im = dft.rdft(jnp.asarray(xp))
    got = np.asarray(dft.autocorr_from_half_power(re**2 + im**2, 2 * n, n))[0]
    want = np.array(
        [np.dot(x[0, : n - k].astype(np.float64), x[0, k:].astype(np.float64)) for k in range(n)]
    )
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-9) < 1e-5

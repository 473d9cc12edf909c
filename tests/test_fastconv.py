"""Fast convolution: JAX op vs oracle (f64 exact; rfft/f32 >= 60 dB)."""

import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.oracle import fastconv as ofc
from jeicyboodsp_tpu.ops import fastconv as jfc


def _signal(rng, n=1024 * 12 + 77):
    t = np.arange(n) / 16000
    x = 4000 * np.sin(2 * np.pi * 440 * t) + rng.normal(0, 1000, n)
    return np.clip(x, -32768, 32767).astype(np.int16)


def test_f64_tight(rng, snr):
    """f64 path: identical up to FFT-backend last-ulp truncation flips
    (jnp.fft vs np.fft round differently; the int16 truncation exposes it on
    a handful of samples).  Contract: |diff| <= 1, <0.1% flipped, SNR huge."""
    x = _signal(rng)
    a, b = ofc.run(x), jfc.run_stream(x, dtype=jnp.float64)
    d = a.astype(int) - b.astype(int)
    assert np.abs(d).max() <= 1
    assert (d != 0).mean() < 3e-3
    assert snr(a, b) >= 80.0


def test_rfft_f32_snr(rng, snr):
    x = _signal(rng)
    ref = ofc.run(x)
    got = jfc.run_stream(x, dtype=jnp.float32, real_fft=True)
    assert snr(ref, got) >= 60.0, snr(ref, got)


def test_warmup_discards_first_seven_blocks(rng):
    """Blocks 0..6 never reach the convolution (uninitialized-queue quirk)."""
    x = _signal(rng)
    x2 = x.copy()
    x2[: 7 * 1024] = 1234  # arbitrarily different warm-up content
    np.testing.assert_array_equal(ofc.run(x), ofc.run(x2))


def test_sparse_engine_matches_oracle(rng, snr):
    """Direct sparse time-domain convolution (70 nonzero RIR taps as static
    scaled slices) matches the oracle's FFT overlap-save to f32 rounding."""
    import jax.numpy as jnp

    from jeicyboodsp_tpu.ops.fastconv import fastconv_blocks_sparse

    n = 16 * 1024
    x = rng.integers(-8000, 8000, n).astype(np.int16)
    want = ofc.run(x)
    got = np.asarray(
        fastconv_blocks_sparse(jnp.asarray(x.reshape(-1, 1024)), dtype=jnp.float32)
    ).reshape(-1)
    assert snr(want, got) >= 60.0, snr(want, got)
    # and exactly in f64
    got64 = np.asarray(
        fastconv_blocks_sparse(jnp.asarray(x.reshape(-1, 1024)), dtype=jnp.float64)
    ).reshape(-1)
    d = np.abs(got64.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, d.max()


def test_gemm_engine_matches_oracle(rng, snr):
    """Banded-Toeplitz direct-GEMM dense engine: exact linear convolution.

    f64 GEMM vs the oracle's f64 FFT overlap-save differs only by FFT
    rounding (+-1 LSB after int16 truncation); f32 GEMM >= 60 dB."""
    from jeicyboodsp_tpu.ops.fastconv import fastconv_blocks_gemm

    x = _signal(rng, n=16 * 1024)
    want = ofc.run(x)
    blocks = jnp.asarray(x.reshape(-1, 1024))
    got64 = np.asarray(fastconv_blocks_gemm(blocks, dtype=jnp.float64)).reshape(-1)
    d = np.abs(got64.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, d.max()
    got32 = np.asarray(fastconv_blocks_gemm(blocks, dtype=jnp.float32)).reshape(-1)
    assert snr(want, got32) >= 60.0, snr(want, got32)
    # run_stream plumbing: dtype flows through -- the default f64 call takes
    # the exact Toeplitz path, an explicit f32 call the float32 (HIGHEST) dot
    via_stream64 = jfc.run_stream(x, fft_engine="gemm")
    want64 = np.asarray(
        fastconv_blocks_gemm(blocks, dtype=jnp.float64)
    ).reshape(-1)
    np.testing.assert_array_equal(via_stream64, want64)
    via_stream32 = jfc.run_stream(x, dtype=jnp.float32, fft_engine="gemm")
    np.testing.assert_array_equal(via_stream32, got32)

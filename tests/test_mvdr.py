"""MVDR: batched JAX op vs oracle."""

import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.oracle import mvdr as omv
from jeicyboodsp_tpu.ops import mvdr as jmv


def _stereo(rng, n=512 * 14 + 100):
    t = np.arange(n) / 16000
    speech = 6000 * np.sin(2 * np.pi * 400 * t) * (((t > 0.12) & (t < 0.2)) | (t > 0.3))
    xl = np.clip(speech + rng.normal(0, 15, n), -32768, 32767).astype(np.int16)
    xr = np.clip(0.8 * speech + rng.normal(0, 15, n), -32768, 32767).astype(np.int16)
    return xl, xr


def test_f64_exact(rng):
    xl, xr = _stereo(rng)
    want = omv.run(xl, xr)
    got = jmv.run_stream(xl, xr)
    assert want.shape == got.shape
    d = want.astype(int) - got.astype(int)
    # np vs jnp FFT backends round differently -> +-1 truncation flips on a
    # small fraction of samples (fraction varies with the draw)
    assert np.abs(d).max() <= 1 and (d != 0).mean() < 0.01, (
        np.abs(d).max(),
        (d != 0).mean(),
    )


def test_f32_snr(rng, snr):
    xl, xr = _stereo(rng)
    want = omv.run(xl, xr)
    got = jmv.run_stream(xl, xr, dtype=jnp.float32)
    assert snr(want, got) >= 60.0, snr(want, got)


def test_mxu_engine_snr(rng, snr):
    """The matmul-DFT engine keeps the compat contract for MVDR."""
    xl, xr = _stereo(rng)
    want = omv.run(xl, xr)
    got = jmv.run_stream(xl, xr, dtype=jnp.float32, fft_engine="mxu3")
    assert snr(want, got) >= 60.0, snr(want, got)


def test_all_speech_input_is_zero_output(rng):
    """Without noise frames R stays singular -> NaN weights -> zeros."""
    n = 512 * 6
    t = np.arange(n) / 16000
    loud = np.clip(20000 * np.sin(2 * np.pi * 500 * t), -32768, 32767).astype(np.int16)
    out = jmv.run_stream(loud, loud)
    assert np.all(out == 0)


def test_collapse_matches_oracle_lsb(rng, snr):
    """The theta=0 structural collapse (ops/mvdr.py: diagonal R from
    time-domain energies, scalar channel mix, no transforms) vs the f64
    oracle's full spectral round-trip: the collapse argument says the
    oracle's off-diagonal r01 is pure f64 roundoff, so outputs must agree
    to +-1 int16 LSB (truncation flips only)."""
    xl, xr = _stereo(rng, 512 * 40 + 256)
    want = omv.run(xl, xr)
    got = jmv.run_stream(xl, xr, dtype=jnp.float32, fft_engine="mxu3")
    d = want.astype(int) - got.astype(int)
    assert np.abs(d).max() <= 1 and (d != 0).mean() < 0.01, (
        np.abs(d).max(), (d != 0).mean(),
    )
    assert snr(want, got) >= 90.0, snr(want, got)  # commit 131c93e's claim


def test_collapse_equals_spectral_mxu3(rng):
    """Collapsed path == the spectral mxu3 path it replaced, on the SAME
    input (collapse=False forces the full DFT round-trip at theta=0).  The
    only differences allowed are the spectral path's own f32/DFT rounding:
    +-1 LSB truncation flips."""
    xl, xr = _stereo(rng, 512 * 24)
    a = jmv.run_stream(xl, xr, dtype=jnp.float32, fft_engine="mxu3", collapse=True)
    b = jmv.run_stream(xl, xr, dtype=jnp.float32, fft_engine="mxu3", collapse=False)
    d = a.astype(int) - b.astype(int)
    assert np.abs(d).max() <= 1 and (d != 0).mean() < 0.05, (
        np.abs(d).max(), (d != 0).mean(),
    )


def test_collapse_parseval_r01_is_roundoff(rng):
    """Numerical check of the Parseval argument: the f64-accumulated
    broadband off-diagonal r01 = sum_k Im-part pairing of L_k, R_k is pure
    roundoff relative to the diagonal energies (exactly zero in exact
    arithmetic for real inputs, since sum_k L_k conj(R_k) = N<l, r> is
    real)."""
    xl, xr = _stereo(rng, 512 * 16)
    T = len(xl) // 512
    bl = xl[: T * 512].reshape(T, 512).astype(np.float64)
    br = xr[: T * 512].reshape(T, 512).astype(np.float64)
    pairs_l = np.concatenate([np.zeros((1, 512)), bl[:-1]], 0)
    pairs_l = np.concatenate([pairs_l, bl], 1)
    pairs_r = np.concatenate([np.zeros((1, 512)), br[:-1]], 0)
    pairs_r = np.concatenate([pairs_r, br], 1)
    L = np.fft.fft(pairs_l)
    R = np.fft.fft(pairs_r)
    r00 = np.sum(L.real**2 + L.imag**2, axis=1) / 1024
    r11 = np.sum(R.real**2 + R.imag**2, axis=1) / 1024
    r01 = np.sum(-L.real * R.imag + L.imag * R.real, axis=1) / 1024
    # per-block: |r01| <= ~sqrt(N)*eps relative to the geometric-mean energy
    scale = np.sqrt(r00 * r11) + 1e-30
    assert (np.abs(r01) / scale).max() < 1e-10, (np.abs(r01) / scale).max()


def test_nonzero_steering_delay_matches_oracle(rng, snr):
    """The reference hardcodes angle 0 (dTime=0); the framework exposes the
    general steering path -- verify op == oracle for a nonzero delay."""
    from jeicyboodsp_tpu.ops.mvdr import steering_delay

    xl, xr = _stereo(rng, 512 * 10)
    dt = steering_delay(0.3)
    want = omv.run(xl, xr, d_time=dt)
    got = jmv.run_stream(xl, xr, d_time=dt)
    d = want.astype(int) - got.astype(int)
    assert np.abs(d).max() <= 1 and (d != 0).mean() < 0.01

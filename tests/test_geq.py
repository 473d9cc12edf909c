"""GEQ: native compat kernel bit-exact vs oracle; JAX scan op close (XLA's
fma contraction can flip truncation boundaries -- see ops/geq.py); fast mode
spectrally equivalent to the linear cascade."""

import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.oracle import geq as ogeq
from jeicyboodsp_tpu.ops import geq as jgeq


def _signal(rng, n=48000):
    t = np.arange(n) / 48000.0
    sig = (
        6000 * np.sin(2 * np.pi * 440 * t)
        + 3000 * np.sin(2 * np.pi * 3000 * t)
        + rng.normal(0, 500, n)
    )
    return np.clip(sig, -32768, 32767).astype(np.int16)


def test_compat_exact_f64(rng):
    """stream_blocks (native C++ kernel) is bit-exact vs the oracle."""
    x = _signal(rng, 2048 + 300)  # ragged tail exercises stale-fread padding
    want = ogeq.run(x)
    got = jgeq.stream_blocks(x, dtype=jnp.float64)
    np.testing.assert_array_equal(want, got)


def test_jax_scan_close(snr):
    """The pure-JAX compat scan matches except where XLA's fma contraction
    flips an exactly-cancelling 0dB-band accumulator (seed 4 is a known
    case); the error stays bounded by the stable feedback."""
    worst = np.inf
    for seed in range(6):
        rng = np.random.default_rng(seed)
        x = _signal(rng, 2048)
        want = ogeq.run(x)
        got = jgeq.stream_blocks(x, dtype=jnp.float64, use_native=False)
        worst = min(worst, snr(want, got))
    assert worst >= 45.0, worst


def test_compat_f32_documented_insufficient(rng, snr):
    """f32 compat is known-insufficient (44 Hz shelf pole at |z|~0.9995
    amplifies coefficient rounding ~2000x at DC); compat runs f64/native."""
    x = _signal(rng, 8192)
    want = ogeq.run(x)
    got = jgeq.stream_blocks(x, dtype=jnp.float32, use_native=False)
    assert snr(want, got) < 60.0  # if this starts passing, revisit kernels


def test_streaming_equals_whole(rng):
    """Block-streamed (with carries) == one whole-signal scan (both JAX)."""
    x = _signal(rng, 2048)
    b, a = jgeq.geq_coefficients()
    blocked = jgeq.stream_blocks(x, dtype=jnp.float64, use_native=False)
    whole, _ = jgeq.geq_apply(jnp.asarray(x), b, a, jgeq.init_state(), dtype=jnp.float64)
    np.testing.assert_array_equal(blocked, np.asarray(whole))


def test_fast_mode_close_to_unquantized_filter(rng, snr):
    """Fast mode is the same cascade without int16 feedback: compare against
    scipy-free float64 sequential filtering."""
    x = _signal(rng, 1536).astype(np.float64)
    b, a = jgeq.geq_coefficients()
    y_ref = x.copy()
    for k in range(7):
        out = np.zeros_like(y_ref)
        for i in range(len(y_ref)):
            out[i] = (
                b[k, 0] * y_ref[i]
                + (b[k, 1] * y_ref[i - 1] if i >= 1 else 0)
                + (b[k, 2] * y_ref[i - 2] if i >= 2 else 0)
                - (a[k, 1] * out[i - 1] if i >= 1 else 0)
                - (a[k, 2] * out[i - 2] if i >= 2 else 0)
            )
        y_ref = out
    y = np.asarray(jgeq.geq_apply_fast(jnp.asarray(x), b, a, dtype=jnp.float64))
    assert snr(y_ref, y) >= 90.0, snr(y_ref, y)

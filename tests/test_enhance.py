"""Enhancement chain: JAX op vs bit-faithful oracle; assoc-scan == scan."""

import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.oracle import enhance as oenh
from jeicyboodsp_tpu.ops import enhance as jenh


def _signal(rng, seconds=1.5, fs=16000):
    n = int(seconds * fs) + 137
    noise = rng.normal(0, 20, n)
    t = np.arange(n) / fs
    speech = 5000 * np.sin(2 * np.pi * 313 * t) * (((t > 0.6) & (t < 1.0)) | (t > 1.2))
    return np.clip(noise + speech, -32768, 32767).astype(np.int16)


def test_wiener_exact_f64(rng):
    x = _signal(rng)
    np.testing.assert_array_equal(oenh.run(x, "wiener"), jenh.run_stream(x, "wiener"))


def test_specsub_exact_f64(rng):
    x = _signal(rng)
    np.testing.assert_array_equal(oenh.run(x, "specsub"), jenh.run_stream(x, "specsub"))


def test_assoc_scan_matches_scan(rng):
    x = _signal(rng)
    a = jenh.run_stream(x, "wiener", use_assoc_scan=False)
    b = jenh.run_stream(x, "wiener", use_assoc_scan=True)
    np.testing.assert_array_equal(a, b)


def test_f32_snr(rng, snr):
    x = _signal(rng)
    ref = oenh.run(x, "wiener")
    got = jenh.run_stream(x, "wiener", dtype=jnp.float32)
    assert snr(ref, got) >= 60.0, snr(ref, got)


def test_vad_flags_match_oracle(rng):
    x = _signal(rng)
    T = len(x) // 512
    blocks = x[: T * 512].reshape(T, 512)
    want = np.array([oenh.vad(b) for b in blocks])
    got = np.asarray(jenh.vad_flags(jnp.asarray(blocks)))
    np.testing.assert_array_equal(want, got)


def test_fast_config_snr(rng, snr):
    """The benched fast config (assoc scan + rfft + ratio resynthesis) keeps
    the >= 60 dB compat contract."""
    x = _signal(rng)
    ref = oenh.run(x, "wiener")
    import jax.numpy as jnp

    T = len(x) // 512
    blocks = jnp.asarray(x[: T * 512].reshape(T, 512))
    out, mask = jenh.enhance_blocks(
        blocks, mode="wiener", dtype=jnp.float32, use_assoc_scan=True,
        real_fft=True, resynth="ratio",
    )
    import numpy as np

    got = np.asarray(out)[np.asarray(mask)].reshape(-1)
    m = min(len(ref), len(got))
    assert snr(ref[:m], got[:m]) >= 60.0, snr(ref[:m], got[:m])


def test_mxu_dft_engine_snr(rng, snr):
    """The matmul-DFT engines keep the compat contract: float32 dots
    ('mxu') and bf16x3 dots ('mxu3') both >= 60 dB vs the f64 oracle."""
    x = _signal(rng)
    ref = oenh.run(x, "wiener")
    T = len(x) // 512
    blocks = jnp.asarray(x[: T * 512].reshape(T, 512))
    for eng in ("mxu", "mxu3"):
        out, mask = jenh.enhance_blocks(
            blocks, mode="wiener", dtype=jnp.float32, use_assoc_scan=True,
            real_fft=True, resynth="ratio", fft_engine=eng,
        )
        got = np.asarray(out)[np.asarray(mask)].reshape(-1)
        m = min(len(ref), len(got))
        assert snr(ref[:m], got[:m]) >= 60.0, (eng, snr(ref[:m], got[:m]))


def test_noise_closed_form_matches_scan(rng):
    """The closed-form noise latch (exact power-of-2 rescaling + weighted
    cumsum) equals the sequential scan bit-for-bit on f64 for this signal
    class, and across chunk boundaries / multiple latch events."""
    x = _signal(rng, seconds=6.5)  # >1 chunk (64 blocks) with many runs
    T = len(x) // 512
    blocks = jnp.asarray(x[: T * 512].reshape(T, 512))
    sp = jenh.vad_flags(blocks, jnp.float64)
    prev = jnp.concatenate([jnp.zeros((1, 512), jnp.int16), blocks[:-1]], axis=0)
    X = jenh.frame_transform(jnp.concatenate([prev, blocks], axis=1), jnp.float64)
    mags = jnp.abs(X)
    want = np.asarray(jenh._noise_scan(sp, mags))
    got = np.asarray(jenh._noise_latch_closed_form(sp, mags))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-30)


def test_fast_mxu_path_matches_oracle_f64(rng):
    """The 512-aligned-GEMM fast path (symmetry-halved inverse, closed-form
    noise) stays within +-1 LSB of the bit-exact oracle in f64 for both
    modes, and reproduces the all-zero NaN path."""
    from jeicyboodsp_tpu.oracle import enhance as oenh

    x = _signal(rng)
    T = len(x) // 512
    x = x[: T * 512]
    blocks = jnp.asarray(x.reshape(T, 512))
    for mode in ("wiener", "specsub"):
        want = oenh.run(x, mode)
        out, mask = jenh.enhance_blocks(
            blocks, mode=mode, dtype=jnp.float64, use_assoc_scan=True,
            real_fft=True, resynth="ratio", fft_engine="mxu",
        )
        got = np.asarray(out)[np.asarray(mask)].reshape(-1)
        d = want.astype(np.int64) - got.astype(np.int64)
        assert np.abs(d).max() <= 1 and (d != 0).mean() < 1e-3, (mode, np.abs(d).max())
    z = np.zeros(512 * 6, np.int16)
    outz, _ = jenh.enhance_blocks(
        jnp.asarray(z.reshape(-1, 512)), mode="wiener", dtype=jnp.float64,
        use_assoc_scan=True, real_fft=True, resynth="ratio", fft_engine="mxu",
    )
    assert np.abs(np.asarray(outz)).max() == 0


def test_noise_closed_form_random_patterns():
    """Property test: the closed-form latch equals the sequential scan on
    random VAD patterns -- hits latch-at-chunk-boundary, multiple latches,
    latch-never-fires, all-noise and all-speech cases."""
    import jax.numpy as jnp

    r = np.random.default_rng(3)
    for trial in range(12):
        T = int(r.integers(3, 300))
        p_speech = r.random()
        speech = jnp.asarray(r.random(T) > p_speech)
        if trial == 0:
            speech = jnp.zeros(T, bool)  # all noise: halving every step
        if trial == 1:
            speech = jnp.ones(T, bool)  # all speech: ns stays zero
        mags = jnp.asarray(np.abs(r.normal(0, 10, (T, 5))))
        want = np.asarray(jenh._noise_scan(speech, mags))
        got = np.asarray(jenh._noise_latch_closed_form(speech, mags))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300, err_msg=str(trial))

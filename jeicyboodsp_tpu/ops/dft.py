"""DFTs as dense matmuls (the ``mxu*`` engines).

For the framework's 1024-pt transforms the DFT can be evaluated as two
dense matmuls against cached cos/sin bases instead of an FFT.  Which is
faster on a given card is a measurement (``PERF.md``); the accuracy is set
by the dot algorithm each engine names.

All matrices are cached numpy f32 constants, embedded at trace time, and
carried as separate real/imag planes.

Engine -> dot algorithm (float32 operands):
  "mxu"  -> Precision.HIGHEST: a true float32 dot (never TF32)
  "mxu3" -> DotAlgorithmPreset.BF16_BF16_F32_X3: three bf16 products
            with float32 accumulation on the tensor cores (less accurate
            than float32: per-pipeline SNRs in PERF.md)
Any other name (e.g. "xla" callers that reach a matmul) gets HIGHEST.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PRECISIONS = {
    "mxu": jax.lax.Precision.HIGHEST,
    "mxu3": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
}


def precision_of(fft_engine: str):
    return PRECISIONS.get(fft_engine, jax.lax.Precision.HIGHEST)


def check_engine(fft_engine: str, allowed=("xla", "mxu", "mxu3")) -> None:
    """Refuse an engine name the caller does not implement (no aliasing)."""
    if fft_engine not in allowed:
        raise ValueError(f"unknown engine {fft_engine!r}; choices: {allowed}")


def int8_col_split(W):
    """Per-column 2-term int8 quantization: W ~= s1*Wh + s2*Wl.

    Wh/Wl int8, s1/s2 positive f64 per-column scales; the second term
    recaptures the first's rounding residual, leaving a worst-case error
    of max|col|/(127*2*127) ~= 2^-16 relative per column.  Paired with an
    EXACT int16 -> 2x int8 data split, this runs f32-class GEMMs as
    int8 x int8 -> int32 dots with exact accumulation.
    """
    W = np.asarray(W, np.float64)
    s1 = np.maximum(np.abs(W).max(0), 1e-30) / 127.0
    Wh = np.rint(W / s1).astype(np.int8)
    R = W - s1 * Wh
    s2 = np.maximum(np.abs(R).max(0), 1e-30) / 127.0
    Wl = np.rint(R / s2).astype(np.int8)
    return Wh, Wl, s1, s2


@functools.lru_cache(maxsize=None)
def _rdft_mats(n: int):
    """Forward real-DFT matrices (n, n//2+1): X_k = x @ (C + iS)."""
    k = np.arange(n)[:, None] * np.arange(n // 2 + 1)[None, :]
    ang = -2.0 * np.pi * k / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _irdft_mats(n: int):
    """Inverse matrices (n//2+1, n) from the non-redundant half-spectrum:
    y_t = re @ IC - im @ IS, assuming Hermitian symmetry (wk doubling)."""
    k = np.arange(n // 2 + 1)[:, None] * np.arange(n)[None, :]
    ang = 2.0 * np.pi * k / n
    wk = np.full((n // 2 + 1, 1), 2.0)
    wk[0] = wk[-1] = 1.0
    ic = (wk * np.cos(ang) / n).astype(np.float32)
    is_ = (wk * np.sin(ang) / n).astype(np.float32)
    return ic, is_


@functools.lru_cache(maxsize=None)
def _icdft_real_mats(n: int):
    """Full-bin inverse, real part only: y = re @ IC - im @ IS, (n, n).

    For spectra that are NOT Hermitian (e.g. MVDR's quirk-merged spectrum)
    this reproduces ``ifft(X).real`` exactly."""
    k = np.arange(n)[:, None] * np.arange(n)[None, :]
    ang = 2.0 * np.pi * k / n
    return (np.cos(ang) / n).astype(np.float32), (np.sin(ang) / n).astype(np.float32)


def rdft(x, precision=jax.lax.Precision.HIGHEST):
    """Real (..., n) -> half-spectrum (re, im) each (..., n//2+1)."""
    n = x.shape[-1]
    C, S = _rdft_mats(n)
    re = jnp.dot(x, jnp.asarray(C), precision=precision)
    im = jnp.dot(x, jnp.asarray(S), precision=precision)
    return re, im


def irdft(re, im, n: int, precision=jax.lax.Precision.HIGHEST):
    """Half-spectrum (re, im) (..., n//2+1) -> real (..., n) (irfft)."""
    IC, IS = _irdft_mats(n)
    return jnp.dot(re, jnp.asarray(IC), precision=precision) - jnp.dot(
        im, jnp.asarray(IS), precision=precision
    )


def full_from_half(re, im):
    """Mirror the non-redundant half-spectrum of a REAL signal to all n bins."""
    re_f = jnp.concatenate([re, re[..., -2:0:-1]], axis=-1)
    im_f = jnp.concatenate([im, -im[..., -2:0:-1]], axis=-1)
    return re_f, im_f


def cdft_of_real_full(x, precision=jax.lax.Precision.HIGHEST):
    """Real (..., n) -> full n-bin spectrum (re, im): fft(x) for real x."""
    return full_from_half(*rdft(x, precision=precision))


def icdft_real(re, im, precision=jax.lax.Precision.HIGHEST):
    """Full-bin (re, im) (..., n) -> ifft(..).real (..., n), no symmetry assumed."""
    n = re.shape[-1]
    IC, IS = _icdft_real_mats(n)
    return jnp.dot(re, jnp.asarray(IC), precision=precision) - jnp.dot(
        im, jnp.asarray(IS), precision=precision
    )


@functools.lru_cache(maxsize=None)
def _autocorr_mats(n: int, keep: int):
    """(n//2+1, keep): ac_t = (1/n) sum_k wk P_k cos(2 pi k t / n) for a
    real symmetric power spectrum given as half bins (Wiener-Khinchin)."""
    k = np.arange(n // 2 + 1)[:, None] * np.arange(keep)[None, :]
    ang = 2.0 * np.pi * k / n
    wk = np.full((n // 2 + 1, 1), 2.0)
    wk[0] = wk[-1] = 1.0
    return (wk * np.cos(ang) / n).astype(np.float32)


def autocorr_from_half_power(p_half, n: int, keep: int, precision=jax.lax.Precision.HIGHEST):
    """Half-bin power spectrum (..., n//2+1) -> autocorrelation (..., keep)."""
    M = _autocorr_mats(n, keep)
    return jnp.dot(p_half, jnp.asarray(M), precision=precision)

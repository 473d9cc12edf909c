"""Radix-2 FFT engine (reference-structured) + roundtrip pipeline.

Reference: ``FFTAlgorithm_ver2.cpp`` (oracle: :mod:`jeicyboodsp_tpu.oracle.fftprog`).

``fft_radix2`` reproduces the reference algorithm's exact stage structure and
truncated-PI twiddles as a batched JAX op (static shapes, the log2(N) stages
unroll at trace time; each stage is one vectorized butterfly + twiddle over
the whole batch).  ``jnp.fft`` remains the production engine for the other
pipelines; this module exists because the reference program's observable
output (int16 roundtrip residue) depends on ITS algorithm.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.oracle.fftprog import BLOCK_LEN, bitrev_indices
from jeicyboodsp_tpu.utils.cnum import FFT_PI, c_short_jnp


@functools.partial(jax.jit, static_argnames=("forward", "n", "dtype"))
def fft_radix2(re, im, forward: bool = True, n: int | None = None, dtype=jnp.float64):
    """Batched reference-structured radix-2 DIT FFT.

    re, im: (..., N) real/imag parts; returns (re, im) unnormalized.
    """
    if n is None:
        n = re.shape[-1]
    assert (n & (n - 1)) == 0, "power-of-two sizes only"
    rev = jnp.asarray(bitrev_indices(n))
    re = re.astype(dtype)[..., rev]
    im = im.astype(dtype)[..., rev]
    sign = -1.0 if forward else 1.0
    npoint = n // 2
    while True:
        n2 = n // npoint
        n1 = n2 // 2
        n3 = n2 * 2
        idx = (n2 * np.arange(npoint)[:, None] + np.arange(n1)[None, :]).ravel()
        idxp = idx + n1
        a_r, a_i = re[..., idx], im[..., idx]
        b_r, b_i = re[..., idxp], im[..., idxp]
        re = re.at[..., idx].set(a_r + b_r).at[..., idxp].set(a_r - b_r)
        im = im.at[..., idx].set(a_i + b_i).at[..., idxp].set(a_i - b_i)
        if npoint == 1:
            break
        k = np.arange(npoint // 2)[:, None]
        nn = np.arange(n2)[None, :]
        idx2 = (k * n3 + n2 + nn).ravel()
        ang = sign * 2.0 * FFT_PI * np.broadcast_to(nn, (npoint // 2, n2)).ravel() / float(n3)
        c = jnp.asarray(np.cos(ang), dtype)
        s = jnp.asarray(np.sin(ang), dtype)
        t_r, t_i = re[..., idx2], im[..., idx2]
        re = re.at[..., idx2].set(c * t_r - s * t_i)
        im = im.at[..., idx2].set(c * t_i + s * t_r)
        npoint //= 2
    return re, im


@functools.partial(jax.jit, static_argnames=("dtype", "engine"))
def roundtrip_blocks(blocks, dtype=jnp.float64, engine: str = "radix2"):
    """(T, 512) int16 -> (T, 512) int16 FFT->IFFT->/N->short, as the program.

    engine="radix2" is the reference-structured algorithm (compat);
    engine="xla" uses jnp.fft (cuFFT on the GPU, +-1 LSB dither only).
    """
    re = blocks.astype(dtype)
    if engine == "xla":
        ctype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
        X = jnp.fft.fft(re.astype(ctype))
        y = jnp.fft.ifft(X).real
        return c_short_jnp(y)
    if engine != "radix2":
        raise ValueError(f"unknown fft engine {engine!r}; choices: ('radix2', 'xla')")
    im = jnp.zeros_like(re)
    Xr, Xi = fft_radix2(re, im, forward=True, n=BLOCK_LEN, dtype=dtype)
    yr, _ = fft_radix2(Xr, Xi, forward=False, n=BLOCK_LEN, dtype=dtype)
    return c_short_jnp(yr / float(BLOCK_LEN))


def run_stream(x, dtype=jnp.float64):
    x = np.asarray(x, np.int16)
    T = len(x) // BLOCK_LEN
    rem = len(x) - T * BLOCK_LEN
    blocks = x[: T * BLOCK_LEN].reshape(T, BLOCK_LEN)
    if rem:
        pad_src = blocks[-1][rem:] if T else np.zeros(BLOCK_LEN - rem, np.int16)
        blocks = np.concatenate([blocks, np.concatenate([x[T * BLOCK_LEN :], pad_src])[None]])
    return np.asarray(roundtrip_blocks(jnp.asarray(blocks), dtype=dtype)).reshape(-1)


def fft_op_counts(n: int = BLOCK_LEN) -> tuple[int, int]:
    """The reference FFT's printed operation counter, replicated exactly
    (``FFTAlgorithm_ver2.cpp:94-148``): adds counted once per butterfly
    pair per stage, multiplies once per twiddle application, no multiply
    pass on the final stage.  512-pt: (2304, 2048).  Used by the CLI's
    --verbose diagnostics (printed after every forward AND inverse call)."""
    add = mul = 0
    npoint = n // 2
    while True:
        n1 = (n // npoint) // 2
        add += npoint * n1
        if npoint == 1:
            break
        mul += (npoint // 2) * (n // npoint)
        npoint //= 2
    return add, mul

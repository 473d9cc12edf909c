"""Overlap-save fast convolution as a batched JAX op.

Reference: ``Fast_Convolution_Based_3DAudio_Impl.cpp`` (oracle:
:mod:`jeicyboodsp_tpu.oracle.fastconv`).

The reference runs one 8192-pt FFT per 1024-sample hop in
a serial loop and re-FFTs the filter every block.  Here the filter spectrum
is precomputed once and ALL segments are transformed in a single batched FFT
-- there is no sequential state at all (the 7168-sample history is just a
gather of the zero-prefixed signal), so the whole pipeline is one
gather + batched FFT + broadcast multiply + batched IFFT + slice.  When the
time axis is sharded across devices, each shard only needs a 7168-sample halo
from its left neighbour (``parallel.halo``).

Fast mode uses rfft in f32 (the signal and RIR are real) for half the
bandwidth and compute.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.oracle.fastconv import (
    BLOCK_SIZE,
    FFT_SIZE,
    FILTER_LENGTH,
    WARMUP_BLOCKS,
    load_rir,
)
from jeicyboodsp_tpu.utils.cnum import c_short_jnp

ENGINES = ("xla", "gemm", "gemm8", "gemm8hq")


def _segments(flat, T):
    """(T*1024,) -> (T-7, 8192) overlapping segments, hop 1024.

    Built from 8 static strided slices (segment t = blocks t..t+7), not a
    gather.
    """
    nseg = T - WARMUP_BLOCKS
    blocks = flat.reshape(T, BLOCK_SIZE)
    parts = [blocks[i : i + nseg] for i in range(WARMUP_BLOCKS + 1)]
    return jnp.concatenate(parts, axis=1)


@functools.partial(jax.jit, static_argnames=("dtype", "real_fft"))
def fastconv_blocks(blocks, Hr, Hi, dtype=jnp.float64, real_fft=False):
    """(T, 1024) int16 blocks -> (T-7, 1024) int16 written output blocks.

    Hr/Hi are the real/imag planes of the precomputed filter spectrum
    ((8192,) for full FFT, (4097,) for rfft mode); split planes because
    complex host<->device transfers are not supported on all backends.
    All segments go through one batched 8192-pt FFT.
    """
    T = blocks.shape[0]
    H = Hr + 1j * Hi
    x_eff = blocks.at[:WARMUP_BLOCKS].set(0)  # warm-up blocks never stored
    flat = x_eff.reshape(-1).astype(dtype)
    segs = _segments(flat, T)

    if real_fft:
        y = jnp.fft.irfft(jnp.fft.rfft(segs) * H, FFT_SIZE)
    else:
        ctype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
        y = jnp.fft.ifft(jnp.fft.fft(segs.astype(ctype)) * H.astype(ctype)).real
    return c_short_jnp(y[:, FILTER_LENGTH - 1 :])


@functools.lru_cache(maxsize=None)
def _sparse_taps():
    """The RIR's 70 nonzero (delay, coefficient) pairs (FilterCoefficient.h:4)."""
    h = np.asarray(load_rir(), np.float64)
    (idx,) = np.nonzero(h)
    return tuple(int(i) for i in idx), tuple(float(h[i]) for i in idx)


@functools.partial(jax.jit, static_argnames=("dtype",))
def fastconv_blocks_sparse(blocks, dtype=jnp.float32):
    """Direct sparse convolution: the RIR has only 70 nonzero taps, so the
    8192-pt FFT pipeline collapses to 70 static-slice scaled adds over the
    flat signal (~140 flops/sample vs ~1000 for the FFT path).  Linear ==
    overlap-save here because the maximum delay (7155) is below the
    7168-sample history the segment carries, so this is numerically the
    same convolution with far less rounding (no spectrum round-trip).  Same framing/warm-up semantics as :func:`fastconv_blocks`.
    """
    T = blocks.shape[0]
    delays, coeffs = _sparse_taps()
    x_eff = blocks.at[:WARMUP_BLOCKS].set(0)
    flat = x_eff.reshape(-1).astype(dtype)
    out_len = (T - WARMUP_BLOCKS) * BLOCK_SIZE
    start = FILTER_LENGTH - 1  # 7168: first emitted sample's global index
    y = jnp.zeros((out_len,), dtype)
    for d, c in zip(delays, coeffs):
        y = y + jnp.asarray(c, dtype) * jax.lax.slice_in_dim(
            flat, start - d, start - d + out_len
        )
    return c_short_jnp(y.reshape(T - WARMUP_BLOCKS, BLOCK_SIZE))


@functools.lru_cache(maxsize=None)
def _toeplitz_matrix(dtype_name: str):
    """(8192, 1024) banded-Toeplitz operator for the dense direct-GEMM engine.

    M[i, t] = h[t + (FILTER_LENGTH-1) - i] where that index is in range, else
    0: ``segment @ M`` is exactly the overlap-save output samples
    [7168:8192] of the 8192-pt circular convolution (the linear convolution
    of the last 1024 samples with the full 7169-tap RIR against the
    7168-sample history the segment carries).  Built host-side once; 32 MB
    in f32, reused across every block.
    """
    h = np.asarray(load_rir(), np.float64)
    i = np.arange(FFT_SIZE)[:, None]
    t = np.arange(BLOCK_SIZE)[None, :]
    k = t + (FILTER_LENGTH - 1) - i
    valid = (k >= 0) & (k < FILTER_LENGTH)
    M = np.where(valid, h[np.clip(k, 0, FILTER_LENGTH - 1)], 0.0)
    return M.astype(np.dtype(dtype_name))


@functools.partial(jax.jit, static_argnames=("dtype",))
def fastconv_blocks_gemm(blocks, M=None, dtype=jnp.float32):
    """Dense-RIR fast convolution as ONE banded-Toeplitz GEMM per hop.

    The general engine for ARBITRARY 7169-tap filters: instead of the
    reference's FFT -> bin multiply -> IFFT round-trip per 1024-sample hop
    (Fast_Convolution_Based_3DAudio_Impl.cpp:139-158), each overlapped
    8192-sample segment is multiplied by a precomputed (8192, 1024) Toeplitz
    operator -- 8192 MACs/sample, a single (nseg,8192)@(8192,1024) matmul
    with no spectral round-trip, no complex arithmetic, and no transform
    error.  The dot is a true float32 (or float64) product,
    ``Precision.HIGHEST``: bf16x3 measured 89.7 dB on the H100, below the
    engine's 95 dB floor (PERF.md).

    Same framing/warm-up semantics as :func:`fastconv_blocks`; exact linear
    convolution (equals the f64 FFT path to FFT rounding).
    """
    T = blocks.shape[0]
    if M is None:  # pass M explicitly in loops: keeps it out of the traced HLO
        M = jnp.asarray(_toeplitz_matrix(np.dtype(dtype).name))
    x_eff = blocks.at[:WARMUP_BLOCKS].set(0)
    flat = x_eff.reshape(-1).astype(dtype)
    segs = _segments(flat, T)
    y = jnp.dot(segs, M, precision=jax.lax.Precision.HIGHEST)
    return c_short_jnp(y)


@functools.lru_cache(maxsize=None)
def _toeplitz_int8():
    """Per-column int8 splits of the Toeplitz operator + the folded +128
    data-shift row (the enhance-chain int8 scheme, ops/dft.int8_col_split),
    plus the THIRD residual term (r5): s3*Mm recaptures the 2-term split's
    remaining error (~2^-22 per column after it)."""
    from jeicyboodsp_tpu.ops.dft import int8_col_split

    M = _toeplitz_matrix("float64")
    Mh, Ml, s1, s2 = int8_col_split(M)
    R = M - (s1 * Mh.astype(np.float64) + s2 * Ml.astype(np.float64))
    s3 = np.maximum(np.abs(R).max(0), 1e-30) / 127.0
    Mm = np.rint(R / s3).astype(np.int8)
    crow = 128.0 * (s1 * Mh.astype(np.int64).sum(0) + s2 * Ml.astype(np.int64).sum(0))
    crow3 = 128.0 * s3 * Mm.astype(np.int64).sum(0)  # 3rd term's +128 fold
    return (Mh, Ml, Mm, s1.astype(np.float32), s2.astype(np.float32),
            s3.astype(np.float32), crow.astype(np.float32), crow3.astype(np.float32))


@functools.partial(jax.jit, static_argnames=("terms",))
def fastconv_blocks_gemm_int8(blocks, terms: int = 3):
    """Toeplitz-GEMM engine as int8 x int8 -> int32 dots.

    The GEMM operands are RAW int16 samples (the convolution is linear), so
    the data side splits EXACTLY into int8 hi/lo planes (x = 256h + l + 128)
    and the operator takes a per-column int8 term expansion:

    - ``terms=2`` (the r4 gemm8 form): four s8xs8->s32 dots (2.0
      bf16-equivalent passes); operator-split residual ~1.5e-5 per column,
      76.6-84.9 dB vs the f64 oracle depending on probe.  Unlike
      the dense DFT bases, the RIR's energy concentrates in 70 taps, which
      concentrates the split residual too -- the l@Ml term is NOT
      negligible (3-dot form measured 54.6 dB, below the 60 dB bar).
    - ``terms=3`` (r5 default): a fifth dot 256*(h@Mm)*s3 recaptures the
      residual (the low byte's pairing with Mm is ~2^-8 of an already
      ~2^-22 correction -- dropped).  Measured +21 dB (84.9 -> 105.8 on
      the engine-matrix probe) for +25% dot work.

    The 256x rescale happens in f32 AFTER the dots (256 * |h@Mh| can
    exceed int32 at K=8192; the dots themselves are int32-exact:
    8192*128*127 = 1.33e8 << 2^31).  Same framing/warm-up semantics as
    :func:`fastconv_blocks_gemm`.  Reference hot loop:
    ``Fast_Convolution_Based_3DAudio_Impl.cpp:139-158``.
    """
    T = blocks.shape[0]
    Mh, Ml, Mm, s1, s2, s3, crow, crow3 = (jnp.asarray(a) for a in _toeplitz_int8())
    x_eff = blocks.at[:WARMUP_BLOCKS].set(0)
    xi = x_eff.reshape(-1).astype(jnp.int32)
    hh = jax.lax.shift_right_arithmetic(xi, jnp.int32(8))  # floor(x/256)
    ll = xi - 256 * hh - 128
    sh = _segments(hh.astype(jnp.int8), T)
    sl = _segments(ll.astype(jnp.int8), T)
    d8 = lambda a, b: jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )
    zh = d8(sh, Mh)
    zl = d8(sl, Mh)
    rh = d8(sh, Ml)
    rl = d8(sl, Ml)
    y = (s1 * (256.0 * zh.astype(jnp.float32) + zl.astype(jnp.float32))
         + s2 * (256.0 * rh.astype(jnp.float32) + rl.astype(jnp.float32))
         + crow)
    if terms >= 3:
        y = y + s3 * (256.0 * d8(sh, Mm).astype(jnp.float32)) + crow3
    return c_short_jnp(y)


def filter_spectrum(h=None, dtype=jnp.float64, real_fft=False):
    """Host-side (numpy) filter spectrum as (real, imag) float planes."""
    if h is None:
        h = load_rir()
    h = np.asarray(h, dtype=np.float64)
    ctype = np.complex64 if dtype == jnp.float32 else np.complex128
    H = np.fft.rfft(h, FFT_SIZE) if real_fft else np.fft.fft(h, FFT_SIZE)
    H = H.astype(ctype)
    return H.real.copy(), H.imag.copy()


def run_stream(x, dtype=jnp.float64, real_fft=False, fft_engine: str = "auto"):
    """Host convenience matching oracle.fastconv.run framing.

    ``fft_engine="auto"`` picks the best engine for the dtype: the f64
    compat path keeps the XLA FFT (bit-level fidelity vs the oracle); the
    f32 fast path defaults to the 3-term int8 Toeplitz GEMM (``gemm8hq``,
    +1 dot over gemm8 for +21 dB; floors pinned in
    tests/test_engine_matrix.py).  ``"gemm8"`` is the 2-term 4-dot form
    (~77-85 dB); ``"gemm"`` the float Toeplitz GEMM (>= 85 dB); ``"xla"``
    the batched ``jnp.fft`` overlap-save.  Any other name raises."""
    x = np.asarray(x, np.int16)
    T = len(x) // BLOCK_SIZE
    rem = len(x) - T * BLOCK_SIZE
    blocks = x[: T * BLOCK_SIZE].reshape(T, BLOCK_SIZE)
    if rem:
        pad_src = blocks[-1][rem:] if T else np.zeros(BLOCK_SIZE - rem, np.int16)
        blocks = np.concatenate([blocks, np.concatenate([x[T * BLOCK_SIZE :], pad_src])[None]])
        T += 1
    if T <= WARMUP_BLOCKS:
        return np.zeros(0, np.int16)
    if fft_engine == "auto":
        fft_engine = "gemm8hq" if dtype == jnp.float32 else "xla"
    if fft_engine not in ENGINES:
        raise ValueError(f"unknown fastconv engine {fft_engine!r}; choices: {ENGINES}")
    if fft_engine in ("gemm8", "gemm8hq"):
        out = fastconv_blocks_gemm_int8(
            jnp.asarray(blocks), terms=3 if fft_engine == "gemm8hq" else 2
        )
    elif fft_engine == "gemm":
        # dtype flows through: f64 callers get the exact f64 Toeplitz GEMM
        out = fastconv_blocks_gemm(jnp.asarray(blocks), dtype=dtype)
    else:
        Hr, Hi = filter_spectrum(dtype=dtype, real_fft=real_fft)
        out = fastconv_blocks(jnp.asarray(blocks), Hr, Hi, dtype=dtype, real_fft=real_fft)
    return np.asarray(out).reshape(-1)

"""Batched feature extractors: MFCC, LPC, pitch (3 methods).

References: ``MFCCFeatureExtraction_auto_version1.cpp``, ``LPCEstimation.cpp``,
``PitchEstimation_method{1,2,3}.cpp`` (oracles: ``oracle.mfcc``,
``oracle.lpc``, ``oracle.pitch``).

All three extractors have *no* cross-block feedback -- their only state is a
keep buffer equal to the previous block -- so the device mapping is pure
batching: frame the signal once, then every frame flows through windowing /
FFT / filterbank / DCT / solves in one vmapped pass.  The mel filterbank and
DCT are matrix products; the Toeplitz solves batch over frames; AMDF /
autocorrelation lags vectorize over a (T, lag, time) tensor or go through
the FFT (Wiener-Khinchin).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.oracle.mfcc import (
    CHANNEL,
    KEEP_LEN,
    LIFTER_LEN,
    MFCC_LEN,
    PRE_EMPHASIS,
    WINDOW_LEN,
    mel_filterbank_init,
)
from jeicyboodsp_tpu.oracle.lpc import LPC_LEN
from jeicyboodsp_tpu.utils.cnum import REF_PI


def hamming(n, dtype=jnp.float64):
    i = jnp.arange(n, dtype=dtype)
    return 0.54 - 0.46 * jnp.cos(2.0 * REF_PI * i / (n - 1))


# ---------------------------------------------------------------------------
# MFCC
# ---------------------------------------------------------------------------


def mel_matrix(dtype=np.float64):
    """(512, 38) sparse-triangular mel weights as a dense matmul operand.

    Row i contributes fb[i] to channel bins[i]-1 and (1-fb[i]) to channel
    bins[i] (oracle.mfcc.mel_apply); dense (512, 38) keeps it one matmul.
    """
    fb, bins = mel_filterbank_init()
    M = np.zeros((KEEP_LEN, CHANNEL), dtype=dtype)
    for i in range(KEEP_LEN):
        k = bins[i]
        if k == 0:
            M[i, 0] += 1 - fb[i]
        else:
            M[i, k - 1] += fb[i]
            if k != CHANNEL:
                M[i, k] += 1 - fb[i]
    return M


def dct_lifter_matrix(dtype=np.float64):
    """(38, 12) combined DCT-II + liftering matrix."""
    i = np.arange(1, MFCC_LEN + 1)[None, :]
    k = np.arange(1, CHANNEL + 1)[:, None]
    basis = np.sqrt(2.0 / CHANNEL) * np.cos(REF_PI * i * (k - 0.5) / CHANNEL)
    lift = 1 + 0.5 * LIFTER_LEN * np.sin(REF_PI * np.arange(1, MFCC_LEN + 1) / LIFTER_LEN)
    return (basis * lift[None, :]).astype(dtype)


@functools.partial(jax.jit, static_argnames=("dtype", "fft_engine"))
def mfcc_frames(frames, mel_m, dct_m, dtype=jnp.float64, fft_engine: str = "xla"):
    """(F, 1024) int16 analysis frames -> (F, 12) MFCC features.

    Each frame is [x[i-1] history ... current] as framed by the caller; the
    pre-emphasis + window + FFT + mel + DCT pipeline matches the oracle.
    ``fft_engine="mxu"`` (f32 only) runs the DFT as float32 matmuls.  There
    is no ``"mxu3"``: bf16x3 dots measured 80.2 dB on the H100, below the
    100 dB floor (the log stage amplifies the basis residual at spectral
    valleys).
    """
    from jeicyboodsp_tpu.ops.dft import check_engine

    check_engine(fft_engine, allowed=("xla", "mxu"))
    f = frames.astype(dtype)
    pre = jnp.concatenate(
        [jnp.zeros((f.shape[0], 1), dtype), f[:, 1:] - PRE_EMPHASIS * f[:, :-1]], axis=1
    )
    w = hamming(WINDOW_LEN, dtype)
    windowed = pre * w
    if fft_engine.startswith("mxu"):
        from jeicyboodsp_tpu.ops import dft as mdft

        re, im = mdft.rdft(windowed, precision=mdft.precision_of(fft_engine))
        xr, xi = re[:, :KEEP_LEN], im[:, :KEEP_LEN]
    elif dtype == jnp.float64:
        X = jnp.fft.fft(windowed.astype(jnp.complex128))[:, :KEEP_LEN]
        xr, xi = X.real, X.imag
    else:
        X = jnp.fft.rfft(windowed)[:, :KEEP_LEN]  # real input; bins 0..511
        xr, xi = X.real, X.imag
    mag = jnp.sqrt(xr ** 2 + xi ** 2)
    # HIGHEST: a float32 dot (the GPU's default f32 dot is TF32, which
    # would cost feature fidelity)
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    mel = mm(mag, mel_m)
    mel_log = jnp.log(mel)
    return mm(mel_log, dct_m)


@functools.partial(jax.jit, static_argnames=("dtype", "fft_engine"))
def mfcc_blocks(blocks, mel_m, dct_m, dtype=jnp.float32, fft_engine: str = "xla"):
    """Jittable MFCC over (..., T, 1024) int16 blocks -> (..., 2T, 12).

    Builds the two 512-hop frames per block from the in-signal keep buffer
    (zeros before t=0) entirely on device; shardable over batch/time by the
    compiler (frame gathers across block boundaries lower to
    collective-permutes when the time axis is sharded).
    """
    *lead, T, B = blocks.shape
    flat = blocks.reshape(*lead, T * B)
    flat = jnp.concatenate(
        [jnp.zeros((*lead, KEEP_LEN), blocks.dtype), flat], axis=-1
    )
    # 2T frames at hop 512 from static slices rather than a gather:
    # rows (2T+1, 512); frame f = rows[f] ++ rows[f+1]
    rows = flat.reshape(*lead, 2 * T + 1, KEEP_LEN)
    frames = jnp.concatenate([rows[..., :-1, :], rows[..., 1:, :]], axis=-1)
    shape = frames.shape
    feats = mfcc_frames(
        frames.reshape(-1, WINDOW_LEN), mel_m, dct_m, dtype=dtype, fft_engine=fft_engine
    )
    return feats.reshape(*shape[:-1], MFCC_LEN)


def mfcc_run(x, dtype=jnp.float64, skip_first: bool = True, fft_engine: str = "xla"):
    """Whole-signal MFCC matching oracle.mfcc.run framing."""
    from jeicyboodsp_tpu.oracle.mfcc import BLOCK_LEN

    x = np.asarray(x, np.int16)
    T = len(x) // BLOCK_LEN
    rem = len(x) - T * BLOCK_LEN
    blocks = x[: T * BLOCK_LEN].reshape(T, BLOCK_LEN)
    if rem:
        pad_src = blocks[-1][rem:] if T else np.zeros(BLOCK_LEN - rem, np.int16)
        blocks = np.concatenate([blocks, np.concatenate([x[T * BLOCK_LEN :], pad_src])[None]])
        T += 1
    flat = np.concatenate([np.zeros(KEEP_LEN, np.int16), blocks.reshape(-1)])
    # two frames per block at hop 512 over [keep, block]
    F = 2 * T
    starts = np.arange(F) * KEEP_LEN
    frames = flat[starts[:, None] + np.arange(WINDOW_LEN)[None, :]]
    mel_m = jnp.asarray(mel_matrix(), dtype)
    dct_m = jnp.asarray(dct_lifter_matrix(), dtype)
    feats = np.asarray(
        mfcc_frames(jnp.asarray(frames), mel_m, dct_m, dtype=dtype, fft_engine=fft_engine)
    )
    return feats[1:] if skip_first else feats


# ---------------------------------------------------------------------------
# LPC
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("dtype", "solver"))
def lpc_frames(frames, dtype=jnp.float64, solver: str = "solve"):
    """(F, 512) int16 analysis windows -> (F, 12) LPC coefficients.

    solver="solve" mirrors the reference's explicit 12x12 Toeplitz inverse
    (LPCEstimation.cpp:115-126) via batched LU; solver="levinson" exploits
    the Toeplitz structure with the O(p^2) Levinson-Durbin recursion -- 12
    static steps of pure elementwise math over all frames (same solution
    as batched LU up to rounding)."""
    n = frames.shape[1]
    w = hamming(n, dtype)
    win = frames.astype(dtype) * w
    lags = jnp.arange(LPC_LEN + 1)

    def corr(lag):
        prod = win[:, : n - 0] * jnp.roll(win, -lag, axis=1)
        mask = jnp.arange(n) < (n - lag)
        return jnp.sum(jnp.where(mask[None, :], prod, 0.0), axis=1) / (n - lag).astype(dtype)

    r = jax.vmap(corr, out_axes=1)(lags)  # (F, 13)
    if solver == "levinson":
        # solve T a = -r[1:] (Yule-Walker): a holds the predictor coeffs
        a = jnp.zeros((frames.shape[0], LPC_LEN), dtype)
        e = r[:, 0]
        for m in range(1, LPC_LEN + 1):
            acc = r[:, m]
            for j in range(1, m):
                acc = acc + a[:, j - 1] * r[:, m - j]
            k = -acc / e
            new_a = a.at[:, m - 1].set(k)
            if m > 1:
                head = a[:, : m - 1] + k[:, None] * a[:, : m - 1][:, ::-1]
                new_a = new_a.at[:, : m - 1].set(head)
            a = new_a
            e = e * (1.0 - k * k)
        return a
    idx = jnp.abs(jnp.arange(LPC_LEN)[:, None] - jnp.arange(LPC_LEN)[None, :])
    T = r[:, idx]  # (F, 12, 12) Toeplitz
    v = -r[:, 1:]
    return jnp.linalg.solve(T, v[..., None])[..., 0]


def lpc_run(x, dtype=jnp.float64):
    from jeicyboodsp_tpu.oracle.lpc import BLOCK_LEN

    x = np.asarray(x, np.int16)
    T = len(x) // BLOCK_LEN
    rem = len(x) - T * BLOCK_LEN
    blocks = x[: T * BLOCK_LEN].reshape(T, BLOCK_LEN)
    if rem:
        pad_src = blocks[-1][rem:] if T else np.zeros(BLOCK_LEN - rem, np.int16)
        blocks = np.concatenate([blocks, np.concatenate([x[T * BLOCK_LEN :], pad_src])[None]])
        T += 1
    flat = np.concatenate([np.zeros(BLOCK_LEN, np.int16), blocks.reshape(-1)])
    starts = np.arange(T) * BLOCK_LEN
    frames = flat[starts[:, None] + np.arange(2 * BLOCK_LEN)[None, :]]
    feats = np.asarray(lpc_frames(jnp.asarray(frames), dtype=dtype))
    return feats[1:]  # first block not written


# ---------------------------------------------------------------------------
# Pitch
# ---------------------------------------------------------------------------

_PITCH_BLOCK = 512
_PITCH_PROC = 1024
_FS = 16000.0


def _pick(ac, pick_max: bool):
    """Reference search: descending scan from 511 to 101 with >= (or <=),
    i.e. the smallest lag in [101, 511] attaining the extremum."""
    sl = ac[:, 101:512]
    ext = jnp.max(sl, axis=1) if pick_max else jnp.min(sl, axis=1)
    arg = 101 + jnp.argmax(sl == ext[:, None], axis=1)
    return arg, ext


@functools.partial(jax.jit, static_argnames=("method", "dtype", "fft_engine"))
def pitch_frames(frames, method: int = 1, dtype=jnp.float64, fft_engine: str = "xla"):
    """(T, 1024) int16 frames [prev, cur] -> (lag (T,), value (T,), f0 (T,))."""
    from jeicyboodsp_tpu.ops.dft import check_engine

    check_engine(fft_engine)
    u = frames.astype(dtype)
    if method == 1:
        if fft_engine.startswith("mxu"):
            # Wiener-Khinchin as matmuls: half-bin power spectrum -> one
            # cosine matmul gives the autocorrelation directly
            from jeicyboodsp_tpu.ops import dft as mdft

            # always HIGHEST here: the observable is an argmax over
            # near-equal period-multiple peaks; 3-pass rounding flips them
            prec = jax.lax.Precision.HIGHEST
            re, im = mdft.rdft(u, precision=prec)
            ac = mdft.autocorr_from_half_power(
                re ** 2 + im ** 2, _PITCH_PROC, _PITCH_BLOCK, precision=prec
            )
        else:
            ctype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
            X = jnp.fft.fft(u.astype(ctype))
            P = X.real ** 2 + X.imag ** 2
            ac = jnp.fft.ifft(P.astype(ctype)).real[:, :_PITCH_BLOCK]
        arg, val = _pick(ac, True)
    elif method == 3 and fft_engine.startswith("mxu"):
        # linear autocorrelation == Wiener-Khinchin on the zero-padded frame:
        # rdft(2048) -> power -> one cosine matmul; exact same sums as the
        # masked time-domain loop, ~100x less HBM traffic than 511 rolls.
        # The padded frame is [u, 0], so the 2048-pt rdft contracts over
        # the 1024 REAL samples only (the zero half contributes exactly
        # nothing) -- u @ C[:1024] with 1024x1024 bases, the 1025th
        # (Nyquist) bin split out as rank-1 terms.  Halves the forward GEMM
        # FLOPs; values are identical (same sums).
        from jeicyboodsp_tpu.ops import dft as mdft

        prec = jax.lax.Precision.HIGHEST  # argmax over near-ties, see above
        n = _PITCH_PROC
        C, S = mdft._rdft_mats(2 * n)  # (2048, 1025) host constants
        re = jnp.dot(u, jnp.asarray(C[:n, :n]), precision=prec)
        im = jnp.dot(u, jnp.asarray(S[:n, :n]), precision=prec)
        re_n = jnp.dot(u, jnp.asarray(C[:n, n]), precision=prec)
        im_n = jnp.dot(u, jnp.asarray(S[:n, n]), precision=prec)
        A = mdft._autocorr_mats(2 * n, _PITCH_BLOCK)  # (1025, 512)
        ac = jnp.dot(re ** 2 + im ** 2, jnp.asarray(A[:n]), precision=prec)
        ac = ac + (re_n ** 2 + im_n ** 2)[:, None] * jnp.asarray(A[n])
        ac = ac / (n - jnp.arange(_PITCH_BLOCK)).astype(dtype)
        arg, val = _pick(ac, True)
    else:
        lags = jnp.arange(_PITCH_BLOCK)
        n = _PITCH_PROC

        def corr(lag):
            shifted = jnp.roll(u, -lag, axis=1)
            mask = (jnp.arange(n) < (n - lag))[None, :]
            if method == 2:
                prod = jnp.abs(u - shifted)
            else:
                prod = u * shifted
            return jnp.sum(jnp.where(mask, prod, 0.0), axis=1) / (n - lag).astype(dtype)

        ac = jax.vmap(corr, out_axes=1)(lags)
        arg, val = _pick(ac, method == 3)
    return arg, val, _FS / arg.astype(dtype)


def pitch_run(x, method: int = 1, dtype=jnp.float64, fft_engine: str = "xla"):
    x = np.asarray(x, np.int16)
    if len(x) == 0:  # the reference program prints nothing on an empty payload
        z = np.zeros(0)
        return z.astype(np.int64), z, z
    T = len(x) // _PITCH_BLOCK
    rem = len(x) - T * _PITCH_BLOCK
    blocks = x[: T * _PITCH_BLOCK].reshape(T, _PITCH_BLOCK)
    if rem:
        pad_src = blocks[-1][rem:] if T else np.zeros(_PITCH_BLOCK - rem, np.int16)
        blocks = np.concatenate([blocks, np.concatenate([x[T * _PITCH_BLOCK :], pad_src])[None]])
        T += 1
    prev = np.concatenate([np.zeros((1, _PITCH_BLOCK), np.int16), blocks[:-1]])
    frames = np.concatenate([prev, blocks], axis=1)
    arg, val, f0 = pitch_frames(
        jnp.asarray(frames), method=method, dtype=dtype, fft_engine=fft_engine
    )
    return np.asarray(arg), np.asarray(val), np.asarray(f0)

"""2-mic MVDR beamformer as a batched JAX op.

Reference: ``BeamForming_MVDR_ver1.cpp`` (oracle:
:mod:`jeicyboodsp_tpu.oracle.mvdr`).

Every per-block stage is a pure function of (x[t-1], x[t])
-- the VAD is stateless, the spatial-correlation pair is always the previous
and current block, and the analysis frame's keep buffer is the previous
block's first 511 samples -- so the only sequential element, the cumulative
2x2 correlation matrix, is an inclusive prefix SUM (trivially parallel /
shardable with psum over a time mesh).  The chain is:

  batched VAD -> per-block R contributions (batched unwindowed FFTs)
  -> masked cumsum of 2x2 matrices -> per-(block, bin) closed-form 2x2
  MVDR weights -> batched frame FFT, weight application (reproducing the
  reference's overwrite-sequencing quirk), batched IFFT -> int16.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.oracle.mvdr import (
    BLOCK_LEN,
    DISTANCE_OF_MIC,
    FFT_LEN,
    KEEP_LEN,
    SAMPLING_RATE,
    SPEED_OF_SOUND,
    THRESHOLD_OF_ENERGY,
)
from jeicyboodsp_tpu.utils.cnum import REF_PI, c_short_jnp


def vad_energy_flags(blocks, dtype=jnp.float64):
    """(T,512) -> (T,) bool speech flags (energy-only MVDR VAD)."""
    i = jnp.arange(FFT_LEN, dtype=dtype)
    w = 0.54 - 0.46 * jnp.cos(2.0 * REF_PI * i / (FFT_LEN - 1))
    wseg = w[KEEP_LEN : KEEP_LEN + BLOCK_LEN]
    s = c_short_jnp(blocks.astype(dtype) * wseg).astype(dtype)
    energy = jnp.sum(s * s, axis=-1) / FFT_LEN
    return energy > THRESHOLD_OF_ENERGY


@functools.partial(jax.jit, static_argnames=("dtype", "fft_engine", "d_time", "collapse"))
def mvdr_blocks(blocks_l, blocks_r, d_time: float = 0.0, dtype=jnp.float64,
                fft_engine: str = "xla", collapse: bool = True):
    """(T, 512) int16 per channel -> ((T, 512) int16, write_mask (T,)).

    ``fft_engine="mxu"``/``"mxu3"`` (f32 only) evaluates the four
    real-input forward FFTs and the non-Hermitian inverse as matmuls (see
    ops/dft.py for each engine's dot algorithm).

    For the reference's actual steering (theta=0, ``:57-60`` -> d_time=0,
    c = [1, 1] at every bin) the fast engine uses a STRUCTURAL collapse:
    for real inputs the broadband off-diagonal correlation is exactly zero
    (Parseval: sum_k L_k conj(R_k) = n<l, r> is real, so its accumulated
    imaginary part vanishes; the reference's nonzero r01 is pure f64
    roundoff), hence R is diagonal, the MVDR weights are REAL per-block
    scalars w0 = d/(a+d), w1 = a/(a+d) with a/d the accumulated channel
    energies (Parseval again: no FFT needed), the overwrite-sequencing
    quirk is a no-op for real weights, and the spectral round-trip
    commutes with the scalar mix: y = w0*frame_l + w1*frame_r.  The whole
    beamformer becomes elementwise work -- no transforms at all.
    ``d_time`` is static so the collapse is a trace-time decision;
    ``collapse=False`` forces the spectral path even at theta=0 (used by
    the tests pinning collapsed == spectral on identical inputs)."""
    T = blocks_l.shape[0]
    fdtype = dtype
    ctype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    from jeicyboodsp_tpu.ops import dft as mdft

    mdft.check_engine(fft_engine)
    use_mxu = fft_engine.startswith("mxu")
    if use_mxu:
        prec = mdft.precision_of(fft_engine)

    speech = vad_energy_flags(blocks_l, fdtype)
    noise = ~speech

    # consecutive-noise run length (same segmented scan as the enhancer)
    def runlen(l, r):
        cl, fl = l
        cr, fr = r
        return jnp.where(fr, cl + cr, cr), fl & fr

    cnt, _ = jax.lax.associative_scan(runlen, (noise.astype(jnp.int32), noise))
    accumulate = noise & (cnt >= 2)

    # per-block R contribution from unwindowed FFT of [x[t-1], x[t]]
    prev_l = jnp.concatenate([jnp.zeros((1, BLOCK_LEN), blocks_l.dtype), blocks_l[:-1]])
    prev_r = jnp.concatenate([jnp.zeros((1, BLOCK_LEN), blocks_r.dtype), blocks_r[:-1]])
    pairs_l = jnp.concatenate([prev_l, blocks_l], axis=1).astype(fdtype)
    pairs_r = jnp.concatenate([prev_r, blocks_r], axis=1).astype(fdtype)

    if use_mxu and float(d_time) == 0.0 and collapse:
        # theta=0 structural collapse (see docstring): diagonal R from
        # time-domain energies, real scalar weights, scalar channel mix
        acc_f = accumulate.astype(fdtype)
        a = jnp.cumsum(jnp.sum(pairs_l * pairs_l, axis=1) * acc_f)  # Parseval
        d = jnp.cumsum(jnp.sum(pairs_r * pairs_r, axis=1) * acc_f)
        denom = a + d
        w0 = d / denom  # 0/0 -> NaN before any accumulation, as the
        w1 = a / denom  # unchecked 2x2 inverse's NaN weights
        # y = ifft(w0 L + w1 R).real = w0 l + w1 r, and the emitted slice
        # frame[511:1023] is exactly the current block, so the keep buffer
        # drops out entirely
        y = w0[:, None] * blocks_l.astype(fdtype) + w1[:, None] * blocks_r.astype(fdtype)
        out = c_short_jnp(y)
        write_mask = jnp.arange(T) >= 1
        return out, write_mask
    if use_mxu:
        Lfr, Lfi = mdft.cdft_of_real_full(pairs_l, precision=prec)
        Rfr, Rfi = mdft.cdft_of_real_full(pairs_r, precision=prec)
    else:
        Lf = jnp.fft.fft(pairs_l.astype(ctype))
        Rf = jnp.fft.fft(pairs_r.astype(ctype))
        Lfr, Lfi, Rfr, Rfi = Lf.real, Lf.imag, Rf.real, Rf.imag
    r00 = jnp.sum(Lfr ** 2 + Lfi ** 2, axis=1) / FFT_LEN
    r01 = jnp.sum(-Lfr * Rfi + Lfi * Rfr, axis=1) / FFT_LEN
    r10 = jnp.sum(-Rfr * Lfi + Rfi * Lfr, axis=1) / FFT_LEN
    r11 = jnp.sum(Rfr ** 2 + Rfi ** 2, axis=1) / FFT_LEN
    contrib = jnp.stack([r00, r01, r10, r11], axis=1) * accumulate[:, None].astype(fdtype)
    R = jnp.cumsum(contrib, axis=0)  # (T, 4) inclusive prefix

    # closed-form 2x2 inverse per block (singular -> inf/nan, as unchecked LU)
    a, b, c_, d = R[:, 0], R[:, 1], R[:, 2], R[:, 3]
    det = a * d - b * c_
    inv = jnp.stack([d, -b, -c_, a], axis=1) / det[:, None]  # (T, 4)

    # steering vector per bin; weights w = R^-1 c / (c^H R^-1 c)
    i = jnp.arange(FFT_LEN, dtype=fdtype)
    ang = 2.0 * REF_PI * i * (SAMPLING_RATE / FFT_LEN) * d_time
    c0 = jnp.ones((FFT_LEN,), ctype)
    c1 = (jnp.cos(ang) + 1j * jnp.sin(ang)).astype(ctype)
    w0 = inv[:, 0, None] * c0[None, :] + inv[:, 1, None] * c1[None, :]  # (T, 1024)
    w1 = inv[:, 2, None] * c0[None, :] + inv[:, 3, None] * c1[None, :]
    denom = jnp.conj(c0)[None, :] * w0 + jnp.conj(c1)[None, :] * w1
    w0 = w0 / denom
    w1 = w1 / denom

    # analysis frames: [prev block's first 511 samples, current, 0]
    keep_l = jnp.concatenate([jnp.zeros((1, KEEP_LEN), blocks_l.dtype), blocks_l[:-1, :KEEP_LEN]])
    keep_r = jnp.concatenate([jnp.zeros((1, KEEP_LEN), blocks_r.dtype), blocks_r[:-1, :KEEP_LEN]])
    zero_tail = jnp.zeros((T, 1), fdtype)
    frame_l = jnp.concatenate([keep_l.astype(fdtype), blocks_l.astype(fdtype), zero_tail], axis=1)
    frame_r = jnp.concatenate([keep_r.astype(fdtype), blocks_r.astype(fdtype), zero_tail], axis=1)
    if use_mxu:
        Lr, Li = mdft.cdft_of_real_full(frame_l, precision=prec)
        Rr, Ri = mdft.cdft_of_real_full(frame_r, precision=prec)
    else:
        L = jnp.fft.fft(frame_l.astype(ctype))
        Rch = jnp.fft.fft(frame_r.astype(ctype))
        Lr, Li, Rr, Ri = L.real, L.imag, Rch.real, Rch.imag

    wl_r, wl_i = w0.real, -w0.imag  # conjugated weights (:175-178)
    wr_r, wr_i = w1.real, -w1.imag
    # overwrite-sequencing quirk (:180-183)
    L0 = Lr * wl_r - Li * wl_i
    L1 = L0 * wl_i + Li * wl_r
    R0 = Rr * wr_r - Ri * wr_i
    R1 = R0 * wr_i + Ri * wr_r
    if use_mxu:
        # the merged spectrum is NOT Hermitian (sequencing quirk), so use the
        # full-bin real-part inverse
        y = mdft.icdft_real(L0 + R0, L1 + R1, precision=prec)
    else:
        merged = ((L0 + R0) + 1j * (L1 + R1)).astype(ctype)
        y = jnp.fft.ifft(merged).real
    out = c_short_jnp(y[:, KEEP_LEN : KEEP_LEN + BLOCK_LEN])
    write_mask = jnp.arange(T) >= 1
    return out, write_mask


def steering_delay(angle_rad: float = 0.0) -> float:
    """dTime = (d/c) * sin(theta) (BeamForming_MVDR_ver1.cpp:60)."""
    return (DISTANCE_OF_MIC / SPEED_OF_SOUND) * float(np.sin(angle_rad))


def run_stream(xl, xr, d_time=0.0, dtype=jnp.float64, fft_engine: str = "xla",
               collapse: bool = True):
    xl = np.asarray(xl, np.int16)
    xr = np.asarray(xr, np.int16)
    n = min(len(xl), len(xr))
    if n == 0:  # the reference emits nothing on an empty payload
        return np.zeros(0, np.int16)

    def blockify(x):
        T = n // BLOCK_LEN
        rem = n - T * BLOCK_LEN
        b = x[: T * BLOCK_LEN].reshape(T, BLOCK_LEN)
        if rem:
            pad_src = b[-1][rem:] if T else np.zeros(BLOCK_LEN - rem, np.int16)
            b = np.concatenate([b, np.concatenate([x[T * BLOCK_LEN : n], pad_src])[None]])
        return b

    bl, br = blockify(xl), blockify(xr)
    out, mask = mvdr_blocks(
        jnp.asarray(bl), jnp.asarray(br), d_time, dtype=dtype,
        fft_engine=fft_engine, collapse=collapse,
    )
    return np.asarray(out)[np.asarray(mask)].reshape(-1)

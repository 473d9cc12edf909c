"""NLMS / BNLMS adaptive filters as JAX ops.

Reference: ``NormalLMS.cpp`` / ``BNLMS.cpp`` (oracle:
:mod:`jeicyboodsp_tpu.oracle.nlms`).

Device mapping:

- Per-sample NLMS (``nlms_apply``) is inherently sequential (the coefficient
  vector updates every sample), so it is a ``lax.scan`` over samples with a
  256-tap carry; batch across independent streams with ``vmap`` for
  throughput.

- Block NLMS (``bnlms_apply``) is the matmul-shaped variant: per block the
  filtering pass is a (1024, 128) Toeplitz-window matmul against the frozen
  coefficients, and the gradient accumulation is the transposed matmul of the
  same window matrix against the weighted errors -- two matmuls per block,
  sequential only in the block-to-block coefficient carry.  The double-talk
  gate's cross-correlation is one FFT-sized batched correlation.

Floating-point accumulation order differs from the C loops (XLA reduces dot
products in its own order), so op-vs-oracle equality is an SNR>=60dB
contract rather than bit equality; the oracle is the bit-exact anchor.

Deliberately NOT implemented: the reference's mu_max eigenvalue bound
(``BNLMS.cpp:188-226`` ``CalcMaxMu``) is dead code behind ``#if 0`` -- it
builds the input autocorrelation Toeplitz matrix but the eigenvalue read is
itself ``#if 0``'d out, so dTemp stays 0 and it would return inf; no caller
exists.  The shipped behavior uses the fixed BNLMS_MU step, which is what we
reproduce.  A working step bound would be
``2 / max_eig(Toeplitz(autocorr))`` via ``jnp.linalg.eigvalsh``; add it only
if a future reference revision enables the block.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.oracle.nlms import (
    BLOCK_LEN,
    BNLMS_EPS,
    BNLMS_KEEP,
    BNLMS_MU,
    BNLMS_TAPS,
    NLMS_EPS,
    NLMS_KEEP,
    NLMS_MU,
    NLMS_TAPS,
)
from jeicyboodsp_tpu.utils.cnum import c_short_jnp

# float32 dots stay float32 on the GPU (its default f32 dot is TF32)
_HI = jax.lax.Precision.HIGHEST
_mm = functools.partial(jnp.matmul, precision=_HI)


def nlms_init_state(dtype=jnp.float64):
    return {
        "hist": jnp.zeros((NLMS_KEEP,), jnp.int32),
        "coeff": jnp.zeros((NLMS_TAPS,), dtype),
    }


@functools.partial(jax.jit, static_argnames=("dtype", "compat"))
def nlms_apply(x, ref, state, dtype=jnp.float64, compat: bool = True):
    """Per-sample NLMS over aligned int16 signals x (far end) / ref (near end).

    Returns (est, err, new_state); est/err int16 of the same length.

    ``compat=True`` reproduces the reference exactly, INCLUDING its
    mirrored-gradient quirk: the estimate is a causal convolution with c
    (``NormalLMS.cpp:113`` pairs c reversed against the ascending-age
    window), but the update (:125) adds the gradient to the MIRROR-image
    taps.  The Wiener fixed point is unchanged (e orthogonal to the whole
    window), but the error dynamics are c_err' = (I - mu' P) c_err with P
    the flip permutation, whose -1 eigenvalue makes every antisymmetric
    error component GROW -- the reference AEC slowly diverges on white
    far-end input (verified: error RMS rises monotonically over 2 M
    samples, identically in the bit-exact oracle/binary).  ``compat=False``
    is the corrected adaptation (gradient paired with the same reversed
    window as the estimate): a textbook convergent NLMS, asserted by the
    ERLE integration test."""
    mu = jnp.asarray(NLMS_MU, dtype)
    eps = jnp.asarray(NLMS_EPS, dtype)

    def step(carry, inp):
        hist, c = carry["hist"], carry["coeff"]
        xi, ri = inp
        w = jnp.concatenate([hist, xi[None]]).astype(dtype)  # u[i..i+255]
        # coeff applied reversed against the window (NormalLMS.cpp:113)
        y_acc = jnp.dot(c[::-1], w, precision=_HI)
        y = c_short_jnp(y_acc).astype(jnp.int32)
        e = (ri - y).astype(dtype)
        norm = jnp.dot(w, w, precision=_HI)
        g = (2.0 * mu) * e / (norm + eps)
        c = c + g * (w if compat else w[::-1])
        new_hist = jnp.concatenate([hist[1:], xi[None]])
        err = c_short_jnp((ri - y).astype(dtype))
        return {"hist": new_hist, "coeff": c}, (y.astype(jnp.int16), err)

    new_state, (est, err) = jax.lax.scan(
        step, state, (x.astype(jnp.int32), ref.astype(jnp.int32))
    )
    return est, err, new_state


def bnlms_init_state(dtype=jnp.float64):
    return {
        "keep_in": jnp.zeros((BNLMS_KEEP,), jnp.int32),
        "keep_ref": jnp.zeros((BNLMS_KEEP,), jnp.int32),
        "coeff": jnp.zeros((BNLMS_TAPS,), dtype),
    }


def _toeplitz_windows(u, taps):
    """(N + taps - 1,) -> (N, taps) sliding windows u[i..i+taps-1].

    Built from `taps` STATIC slices (one per column) rather than a gather:
    static slices are pure data movement that XLA fuses (same choice as the
    MFCC framing path)."""
    n = u.shape[0] - taps + 1
    return jnp.stack([jax.lax.slice_in_dim(u, k, k + n) for k in range(taps)], axis=1)


def _double_talk(u, r, dtype):
    """BNLMS.cpp:164-186 with OOB reads defined as zero.

    corr[k] = sum_i u[i] * r[i+k] / (2048 - k), k in [0, 1024); returns True
    for double talk (max corr <= 0).
    """
    n = 2 * BLOCK_LEN
    up = jnp.zeros((n,), dtype).at[: u.shape[0]].set(u.astype(dtype))
    rp = jnp.zeros((2 * n,), dtype).at[: r.shape[0]].set(r.astype(dtype))
    # cross-correlation via FFT: corr[k] = sum_i up[i] rp[i+k]
    m = 2 * n
    U = jnp.fft.rfft(up, m)
    R = jnp.fft.rfft(rp[:m], m)
    corr = jnp.fft.irfft(jnp.conj(U) * R, m)[:BLOCK_LEN]
    corr = corr / (n - jnp.arange(BLOCK_LEN, dtype=dtype))
    return jnp.max(corr) <= 0.0


@functools.partial(jax.jit, static_argnames=("dtype",))
def bnlms_apply_block(x, ref, state, dtype=jnp.float64):
    """One 1024-sample block of BNLMS (BlockLMSFilter, BNLMS.cpp:103-162)."""
    c = state["coeff"]
    u = jnp.concatenate([state["keep_in"], x.astype(jnp.int32)])
    r = jnp.concatenate([state["keep_ref"], ref.astype(jnp.int32)])
    W = _toeplitz_windows(u.astype(dtype), BNLMS_TAPS)  # (1024, 128)
    y_acc = _mm(W, c[::-1])
    y = c_short_jnp(y_acc).astype(jnp.int32)
    e_int = ref.astype(jnp.int32) - y
    err = c_short_jnp(e_int.astype(dtype))

    norm = jnp.sum(W * W, axis=1)  # per-sample window energy
    g = (2.0 * BNLMS_MU) * e_int.astype(dtype) / (norm + BNLMS_EPS)
    grad = _mm(W.T, g)  # (128,)
    no_dt = ~_double_talk(u, r, dtype)
    c = jnp.where(no_dt, c + grad / BLOCK_LEN, c)

    new_state = {
        "keep_in": x.astype(jnp.int32)[BLOCK_LEN - BNLMS_KEEP :],
        "keep_ref": ref.astype(jnp.int32)[BLOCK_LEN - BNLMS_KEEP :],
        "coeff": c,
    }
    return y.astype(jnp.int16), err, new_state


@functools.partial(jax.jit, static_argnames=("dtype",))
def bnlms_apply(x_blocks, ref_blocks, state, dtype=jnp.float64):
    """Scan BNLMS over (T, 1024) blocks; two matmuls per step."""

    def step(st, inp):
        xb, rb = inp
        est, err, st = bnlms_apply_block(xb, rb, st, dtype=dtype)
        return st, (est, err)

    state, (est, err) = jax.lax.scan(step, state, (x_blocks, ref_blocks))
    return est, err, state


_GATE_M = 2176  # any m >= 1151 + 1023 gives linear correlation; no radix need


@functools.lru_cache(maxsize=1)
def _gate_bases():
    """Matmul-DFT bases for the double-talk correlation (host constants):
    forward (1151, 1089) cos/sin planes over the nonzero input rows only,
    inverse (1089, 1024) with the irfft weights folded in."""
    m = _GATE_M
    nbin = m // 2 + 1
    i = np.arange(BLOCK_LEN + BNLMS_KEEP)[:, None] * np.arange(nbin)[None, :]
    ang = -2.0 * np.pi * i / m
    Fc = np.cos(ang).astype(np.float32)
    Fs = np.sin(ang).astype(np.float32)
    wk = np.full(nbin, 2.0)
    wk[0] = wk[-1] = 1.0
    kl = np.arange(nbin)[:, None] * np.arange(BLOCK_LEN)[None, :]
    ang2 = 2.0 * np.pi * kl / m
    Ic = (wk[:, None] * np.cos(ang2) / m).astype(np.float32)
    Is = (wk[:, None] * np.sin(ang2) / m).astype(np.float32)
    return Fc, Fs, Ic, Is


def _bnlms_gates(xp, rp):
    """Double-talk gate per (stream, block), vectorized (BNLMS.cpp:164-186).

    corr[k] = sum_i u[i]*r[i+k] / (2*BLOCK-k) over the 1151-sample
    processing buffers (keep(127) + block), out-of-bounds reads defined as
    zero (see oracle module docstring); update fires iff max_k corr[k] > 0.
    Pure function of the inputs, so it is computed once for every block of
    every stream as float32 matmul-DFT GEMMs.  xp, rp: (B, T) with T a
    multiple of 1024; returns (B, T // 1024) float32 0/1 flags.  The sign
    decision matches the f64 oracle except when max|corr| is within float32
    rounding of zero."""
    B, T = xp.shape
    tb = T // BLOCK_LEN
    xb = xp.reshape(B, tb, BLOCK_LEN)
    rb = rp.reshape(B, tb, BLOCK_LEN)

    def with_keep(blocks):
        halo = jnp.pad(blocks, ((0, 0), (1, 0), (0, 0)))[:, :-1, BLOCK_LEN - BNLMS_KEEP :]
        return jnp.concatenate([halo, blocks], axis=-1)  # (B, tb, 1151)

    u = with_keep(xb).reshape(B * tb, BLOCK_LEN + BNLMS_KEEP)
    r = with_keep(rb).reshape(B * tb, BLOCK_LEN + BNLMS_KEEP)
    Fc, Fs, Ic, Is = _gate_bases()
    Ur, Ui = _mm(u, Fc), _mm(u, Fs)
    Rr, Ri = _mm(r, Fc), _mm(r, Fs)
    Pr = Ur * Rr + Ui * Ri  # conj(U) * R
    Pi = Ur * Ri - Ui * Rr
    corr = _mm(Pr, Ic) - _mm(Pi, Is)  # (B*tb, 1024) linear correlation lags
    corr = corr / (2.0 * BLOCK_LEN - jnp.arange(BLOCK_LEN, dtype=jnp.float32))
    return (jnp.max(corr, axis=-1) > 0.0).astype(jnp.float32).reshape(B, tb)


def bnlms_affine_elements(x_blocks, ref_blocks, dtype=jnp.float32,
                          keep_in=None, keep_ref=None, chunk: int = 64):
    """Per-block affine maps (A_b, v_b) of the BNLMS coefficient recursion.

    SURVEY §5 flagged BNLMS's per-block update as "already the
    block-parallel-friendly variant": once the estimate's int16 truncation
    is linearized OUT of the recursion (it stays on the OUTPUT path), the
    update is affine in the coefficient vector c --

        c_{b+1} = A_b c_b + v_b
        A_b = I - gate_b * (2mu/N) * W_b^T D_b W_b^P
        v_b =     gate_b * (2mu/N) * W_b^T D_b ref_b

    with W_b the (1024, 128) input Toeplitz windows, D_b = diag(1/(norm_t
    + eps)) the per-sample energy normalizers, W^P = W with columns
    flipped (the reference's mirrored estimate/update pairing,
    BNLMS.cpp:126-128 vs :144 -- preserved exactly, including its slow
    antisymmetric divergence), and gate_b the double-talk decision
    (input-only, batched via the matmul-DFT gate).  EVERY quantity is a
    pure function of the inputs, so the A/v elements build in one batched
    pass and the c-sequence is an associative scan -- O(log T) depth on
    one chip, and time-shardable across chips with
    parallel.halo.sharded_associative_scan (the formulation VERDICT r4
    missing-item 3 asked for).

    The only deviation from the sequential reference is dropping c_short
    on y INSIDE the error feedback (<= 0.5 LSB perturbation per sample,
    no wrap amplification -- unlike GEQ, the truncation here is not fed
    through an int16-wrap nonlinearity); measured SNR vs the f64 compat
    oracle is pinned in tests/test_nlms.py.

    Returns (A (T, 128, 128), v (T, 128), W (T, 1024, 128), gates (T,)).

    ``keep_in``/``keep_ref``: the FULL previous 1024-sample blocks (zeros
    when the stream starts here) -- both the 127-sample Toeplitz keep and
    the double-talk gate's halo derive from them, so a time-sharded caller
    only needs a 1-block ppermute halo.

    ``chunk``: blocks per lax.map step of the A/v build (the largest
    divisor of T not above it); bounds the live (chunk, 1024, 128) window
    temps without changing any value.
    """
    T = x_blocks.shape[0]
    pz = jnp.zeros((BLOCK_LEN,), jnp.int32)
    pxb = pz if keep_in is None else keep_in.astype(jnp.int32)
    prb = pz if keep_ref is None else keep_ref.astype(jnp.int32)
    xi = x_blocks.astype(jnp.int32)
    ri = ref_blocks.astype(jnp.int32)
    # windows are continuous across blocks (the keep IS the previous tail),
    # so W builds from slice-stacks over the flat signal.  The A/v build
    # runs as a lax.map over chunks of CH blocks, which bounds the live
    # set of the (CH, 1024, 128) window temps.
    flat = jnp.concatenate([pxb[BLOCK_LEN - BNLMS_KEEP :], xi.reshape(-1)]).astype(dtype)
    # the double-talk gate is input-only; reuse the batched matmul-DFT gate
    # (prepend the halo block so the first local gate sees its true keep,
    # then drop the halo block's own gate)
    gates = _bnlms_gates(
        jnp.concatenate([pxb[None], xi], axis=0).reshape(1, -1).astype(jnp.float32),
        jnp.concatenate([prb[None], ri], axis=0).reshape(1, -1).astype(jnp.float32),
    )[0, 1:].astype(dtype)  # (T,)
    eta = jnp.asarray(2.0 * BNLMS_MU / BLOCK_LEN, dtype)
    hi = _HI
    CH = next(c for c in range(min(chunk, T), 0, -1) if T % c == 0)
    segs = jnp.stack(  # (T/CH, CH*1024 + 127) overlapping flat segments
        [flat[c * CH * BLOCK_LEN : (c + 1) * CH * BLOCK_LEN + BNLMS_KEEP]
         for c in range(T // CH)]
    )
    rfc = ri.astype(dtype).reshape(T // CH, CH * BLOCK_LEN)
    gc = gates.reshape(T // CH, CH)

    def build(args):
        seg, rc, g = args
        Wc = _toeplitz_windows(seg, BNLMS_TAPS).reshape(CH, BLOCK_LEN, BNLMS_TAPS)
        Dc = 1.0 / (jnp.sum(Wc * Wc, axis=2) + jnp.asarray(BNLMS_EPS, dtype))
        WD = Wc * Dc[:, :, None]
        Mc = jnp.einsum("bti,btj->bij", WD, Wc[:, :, ::-1], precision=hi)
        Ac = jnp.eye(BNLMS_TAPS, dtype=dtype)[None] - (eta * g)[:, None, None] * Mc
        vc = (eta * g)[:, None] * jnp.einsum(
            "bti,bt->bi", WD, rc.reshape(CH, BLOCK_LEN), precision=hi
        )
        return Ac, vc

    A, v = jax.lax.map(build, (segs, rfc, gc))
    A = A.reshape(T, BNLMS_TAPS, BNLMS_TAPS)
    v = v.reshape(T, BNLMS_TAPS)
    W = _toeplitz_windows(flat, BNLMS_TAPS).reshape(T, BLOCK_LEN, BNLMS_TAPS)
    return A, v, W, gates


def affine_combine(l, r):
    """(A, v) monoid: r AFTER l.  Identity: (I, 0)."""
    Al, vl = l
    Ar, vr = r
    hi = _HI
    return (
        jnp.einsum("...ij,...jk->...ik", Ar, Al, precision=hi),
        jnp.einsum("...ij,...j->...i", Ar, vl, precision=hi) + vr,
    )


@functools.partial(jax.jit, static_argnames=("dtype", "chunk"))
def bnlms_apply_timeparallel(x_blocks, ref_blocks, dtype=jnp.float32, chunk: int = 64):
    """Block-parallel BNLMS over (T, 1024) far/near blocks: O(log T) depth.

    See :func:`bnlms_affine_elements` for the formulation and its (small,
    documented) deviation from the sequential compat path.  Returns
    (est, err) int16 -- same output contract as :func:`bnlms_apply`
    (outputs are c_short-quantized; only the recursion is linearized).
    """
    A, v, W, _ = bnlms_affine_elements(x_blocks, ref_blocks, dtype=dtype, chunk=chunk)
    _, v_incl = jax.lax.associative_scan(affine_combine, (A, v))
    # c_b = state BEFORE block b: exclusive prefix (c_0 = 0)
    c = jnp.concatenate([jnp.zeros((1, BNLMS_TAPS), dtype), v_incl[:-1]], axis=0)
    y = jnp.einsum("bti,bi->bt", W[:, :, ::-1], c, precision=_HI)
    y_s = c_short_jnp(y)
    e = ref_blocks.astype(jnp.int32) - y_s.astype(jnp.int32)
    return y_s.astype(jnp.int16), c_short_jnp(e.astype(dtype)).astype(jnp.int16)


def _blockify(x, block):
    x = np.asarray(x, np.int16)
    T = len(x) // block
    rem = len(x) - T * block
    blocks = x[: T * block].reshape(T, block)
    if rem:
        pad_src = blocks[-1][rem:] if T else np.zeros(block - rem, np.int16)
        blocks = np.concatenate([blocks, np.concatenate([x[T * block :], pad_src])[None]])
    return blocks


def run_nlms_stream(x, ref, dtype=jnp.float64, use_native=True, verbose=False,
                    compat=True):
    """Host convenience matching oracle.run_nlms output framing.

    f64 compat prefers the native C++ kernel (bit-exact, and far faster than
    a per-sample scan on host).  ``verbose`` prints the reference's
    per-block coefficient diagnostic (``NormalLMS.cpp:128``) -- block by
    block through the native kernel, so the printed trajectory is the
    bit-exact one.  ``compat=False`` selects the corrected (convergent)
    adaptation -- see :func:`nlms_apply`; it runs on the JAX path."""
    n = min(len(x), len(ref))
    xb = _blockify(x[:n], BLOCK_LEN)
    rb = _blockify(ref[:n], BLOCK_LEN)
    if not compat:
        est, err, _ = nlms_apply(
            jnp.asarray(xb.reshape(-1)), jnp.asarray(rb.reshape(-1)),
            nlms_init_state(dtype), dtype=dtype, compat=False,
        )
        return (
            np.asarray(est).reshape(xb.shape)[1:].reshape(-1),
            np.asarray(err).reshape(xb.shape)[1:].reshape(-1),
        )
    if use_native and dtype == jnp.float64:
        from jeicyboodsp_tpu import native

        if native.available():
            coeff = np.zeros(NLMS_TAPS, np.float64)
            keep = np.zeros(NLMS_KEEP, np.int16)
            if verbose:
                import sys

                ests, errs = [], []
                for t in range(xb.shape[0]):
                    e1, e2 = native.nlms_process(xb[t], rb[t], coeff, keep)
                    ests.append(e1)
                    errs.append(e2)
                    sys.stdout.write(
                        "rgsdCoefficient[0] %f, rgsdCoefficient[1] %f, "
                        "rgsdCoefficient[2] %f \n" % (coeff[0], coeff[1], coeff[2])
                    )
                est = np.concatenate(ests)
                err = np.concatenate(errs)
                return est[BLOCK_LEN:], err[BLOCK_LEN:]
            est, err = native.nlms_process(xb.reshape(-1), rb.reshape(-1), coeff, keep)
            return est[BLOCK_LEN:], err[BLOCK_LEN:]
    est, err, _ = nlms_apply(
        jnp.asarray(xb.reshape(-1)), jnp.asarray(rb.reshape(-1)), nlms_init_state(dtype), dtype=dtype
    )
    # first block not written (NormalLMS.cpp:132-135)
    return np.asarray(est).reshape(xb.shape)[1:].reshape(-1), np.asarray(err).reshape(xb.shape)[1:].reshape(-1)


def run_bnlms_stream(x, ref, dtype=jnp.float64, use_native=True):
    """Host convenience matching oracle.run_bnlms output framing; f64 compat
    prefers the native C++ kernel (bit-exact), otherwise the JAX scan."""
    n = min(len(x), len(ref))
    xb = _blockify(x[:n], BLOCK_LEN)
    rb = _blockify(ref[:n], BLOCK_LEN)
    if use_native and dtype == jnp.float64:
        from jeicyboodsp_tpu import native

        if native.available():
            coeff = np.zeros(BNLMS_TAPS, np.float64)
            ki = np.zeros(BNLMS_KEEP, np.int16)
            kr = np.zeros(BNLMS_KEEP, np.int16)
            est, err = native.bnlms_process(xb.reshape(-1), rb.reshape(-1), coeff, ki, kr)
            return est[BLOCK_LEN:], err[BLOCK_LEN:]
    est, err, _ = bnlms_apply(jnp.asarray(xb), jnp.asarray(rb), bnlms_init_state(dtype), dtype=dtype)
    return np.asarray(est)[1:].reshape(-1), np.asarray(err)[1:].reshape(-1)

"""Wiener / spectral-subtraction enhancement chain as a batched JAX op.

Reference: ``WienerFilter_final.cpp`` / ``SpectralSubtraction_final.cpp``
(see :mod:`jeicyboodsp_tpu.oracle.enhance` for the full semantics).

Unlike the reference's strictly serial block loop, every heavy stage here
is batched over *all* blocks at once:

1. VAD is a pure function of each block (the reference's VAD keep-buffer
   update is dead code), so flags are computed with one vectorized pass.
2. Both the noise estimator and the filter transform the same frame
   ``w * [x[t-1], x[t]]`` (the estimator's keep buffer always equals the
   previous block), so ONE batched 1024-pt FFT over (T, 1024) feeds both.
3. The only sequential state -- the noise running average + 10-frame latch --
   is a tiny affine recursion on a 1024-vector, evaluated either as a
   ``lax.scan`` (cheap) or as an O(log T) ``associative_scan`` whose affine
   composition is exact, enabling time-sharding across devices.
4. Overlap-add reduces to ``y[t][:512] + y[t-1][512:]`` (1-frame halo), so
   reconstruction is also one batched op; across shards the halo travels by
   ``ppermute``.

Engines (``fft_engine``): ``"xla"`` transforms with ``jnp.fft`` (cuFFT on
the GPU); ``"mxu"`` and ``"mxu3"`` evaluate the 1024-pt DFT as dense
matmuls (:mod:`jeicyboodsp_tpu.ops.dft` names the dot algorithm of each).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.utils.cnum import REF_PI, c_short_jnp

BLOCK_LEN = 512
FFT_SIZE = 1024
THRESHOLD_OF_ENERGY = 700.0
THRESHOLD_OF_ZCR = 200.0
NOISE_FRAMES = 10


def hamming_ref(n: int, dtype=jnp.float64):
    i = jnp.arange(n, dtype=dtype)
    return 0.54 - 0.46 * jnp.cos(2.0 * REF_PI * i / (n - 1))


def vad_flags(blocks, dtype=jnp.float64):
    """Vectorized VAD over (T, 512) int16 blocks -> (T,) bool (True=speech).

    Semantics of WienerFilter_final.cpp:261-296 including the in-place int16
    window truncation and the windowed[i] x raw[i+1] ZCR pairing.
    """
    w = hamming_ref(FFT_SIZE, dtype)[BLOCK_LEN:]
    x = blocks.astype(dtype)
    s = c_short_jnp(x * w).astype(dtype)  # truncated windowed samples
    energy = jnp.sum(s * s, axis=-1) / FFT_SIZE
    nxt = jnp.concatenate(  # raw next sample; last pairs with OOB -> 0
        [blocks[..., 1:].astype(dtype), jnp.zeros(blocks.shape[:-1] + (1,), dtype)],
        axis=-1,
    )
    zcr = jnp.sum((s * nxt) < 0, axis=-1)
    return (energy > THRESHOLD_OF_ENERGY) | (zcr < THRESHOLD_OF_ZCR)


def _noise_scan(speech, mags):
    """Sequential noise-estimate state over T blocks.

    carry: (cnt, avg (1024,), latched (1024,)); reproduces
    WienerFilter_final.cpp:97-108 + 120-159.
    """
    dtype = mags.dtype

    def step(carry, inp):
        cnt, avg, latched = carry
        sp, m = inp
        cnt = jnp.where(sp, 0, cnt + 1)
        run = (~sp) & (cnt >= 2)
        avg2 = jnp.where(run, jnp.where(cnt >= 3, (avg + m) / 2.0, avg + m), avg)
        latched2 = jnp.where(run & (cnt == NOISE_FRAMES), avg2, latched)
        return (cnt, avg2, latched2), latched2

    nbins = mags.shape[-1]
    init = (jnp.zeros((), jnp.int32), jnp.zeros(nbins, dtype), jnp.zeros(nbins, dtype))
    _, latched_per_t = jax.lax.scan(step, init, (speech, mags))
    return latched_per_t


def runlen_combine(l, r):
    """Segmented-count monoid: (count, all_noise_flag). Identity: (0, True)."""
    cl, fl = l
    cr, fr = r
    return jnp.where(fr, cl + cr, cr), fl & fr


def noise_affine_combine(l, r):
    """Noise-state monoid: A' = a*A + b ; N' = s ? ah*A + bh : N.

    Identity: (1, 0, False, 0, 0).  The LAST latch wins on composition.
    Scalar elements (a, s, ah) broadcast over any batch dims against the
    vector elements (b, bh) via a trailing-axis expand.
    """
    al, bl, sl, ahl, bhl = l
    ar, br, sr, ahr, bhr = r
    a_ = ar * al
    b_ = ar[..., None] * bl + br
    s_ = sl | sr
    ah_ = jnp.where(sr, ahr * al, ahl)
    bh_ = jnp.where(sr[..., None], ahr[..., None] * bl + bhr, bhl)
    return a_, b_, s_, ah_, bh_


def noise_affine_elements(speech, cnt, mags):
    """Per-block monoid elements from VAD flags, run-lengths, magnitudes."""
    dtype = mags.dtype
    noise = ~speech
    run = (cnt >= 2) & noise
    a = jnp.where(run, jnp.where(cnt >= 3, 0.5, 1.0), 1.0).astype(dtype)
    b = jnp.where(
        run[..., None], jnp.where(cnt[..., None] >= 3, 0.5, 1.0) * mags, 0.0
    ).astype(dtype)
    s = run & (cnt == NOISE_FRAMES)
    ah = jnp.where(s, a, 0.0)
    bh = jnp.where(s[..., None], b, 0.0)
    return a, b, s, ah, bh


def latched_from_composed(s_, bh_):
    """N_t given zero initial state: latched value or zeros."""
    return jnp.where(s_[..., None], bh_, jnp.zeros_like(bh_))


def _noise_assoc_scan(speech, mags):
    """Associative-scan version of :func:`_noise_scan` (O(log T) depth).

    Per block the update is affine in the running average A:
        A' = a*A + b*m ,  N' = latch ? A' : N
    Composition is closed (see :func:`noise_affine_combine`), so the whole
    state sequence is a parallel prefix -- this is what makes the chain
    time-shardable across chips without serializing on the carry.
    """
    noise = ~speech
    cnt, _ = jax.lax.associative_scan(runlen_combine, (noise.astype(jnp.int32), noise))
    elems = noise_affine_elements(speech, cnt, mags)
    _, _, s_, _, bh_ = jax.lax.associative_scan(noise_affine_combine, elems)
    return latched_from_composed(s_, bh_)


def _noise_latch_parts(speech, planes, chunk: int = 64):
    """Closed-form noise latch -- the chain's fast path.

    The recursion A' = a*A + c*m has a ∈ {1, 1/2}: every decay is an EXACT
    power of two, so with k_t = #halvings up to t,

        A_t = 2^{-k_t} * Σ_{j<=t} 2^{k_j} c_j m_j

    i.e. ONE weighted cumulative sum with scalar per-block weights -- ~4x
    less memory traffic than the affine associative scan (whose monoid
    carries two bin-vectors).  2^{k} overflows f32 for long signals, so the
    sum is rescaled per `chunk` blocks (local k <= chunk < 127) and chunks
    are composed by a tiny (T/chunk)-step affine scan.  The 2^{±k} scalings
    are exact; only addition grouping differs from the sequential scan
    (same ulp class as the associative scan).

    The latched output N_t is A at the most recent block where a noise run
    reached NOISE_FRAMES: a cummax of latch indices + one row gather.

    ``planes`` is a tuple of (T, nb_i) magnitude planes latched with the
    SAME scalar machinery.
    """
    dtype = planes[0].dtype
    T = planes[0].shape[0]
    L = chunk
    Tp = -(-T // L) * L
    idx = jnp.arange(Tp)
    noise = jnp.zeros(Tp, bool).at[:T].set(~speech)  # pad rows = speech

    last_speech = jax.lax.cummax(jnp.where(~noise, idx, -1))
    cnt = jnp.where(noise, idx - last_speech, 0)  # run length, 0 on speech
    upd = noise & (cnt >= 2)
    halve = upd & (cnt >= 3)  # a = 1/2 (cnt==2 keeps a=1, c=1)
    c = jnp.where(upd, jnp.where(cnt >= 3, 0.5, 1.0), 0.0).astype(dtype)

    k = jnp.cumsum(halve.astype(jnp.int32))  # halvings up to AND incl. t
    k2 = k.reshape(Tp // L, L)
    lk = k2 - jnp.concatenate(  # halvings within the chunk
        [jnp.zeros((1,), jnp.int32), k2[:-1, -1]]
    )[:, None]
    w = c.reshape(Tp // L, L) * jnp.exp2(lk.astype(dtype))  # exact scaling
    # prefix sums within chunks as a lower-triangular matmul; HIGHEST keeps
    # it a float32 dot (the GPU's default f32 dot is TF32)
    tri = jnp.asarray(np.tril(np.ones((L, L), np.float32)), dtype)
    p = jnp.exp2(-lk.astype(dtype))  # exact

    # cross-chunk composition A_out = p_c (A_in + S_c): tiny affine
    # associative scan over T/L chunk aggregates (log depth)
    def comb(l, r):
        a1, b1 = l
        a2, b2 = r
        return a2 * a1, a2[..., None] * b1 + b2

    a_el = p[:, -1]
    latch = upd & (cnt == NOISE_FRAMES)
    lidx = jax.lax.cummax(jnp.where(latch, idx, -1))
    have = (lidx >= 0)[:, None]
    gidx = jnp.maximum(lidx, 0)[:, None]

    outs = []
    for mags in planes:
        nb = mags.shape[1]
        m = jnp.zeros((Tp, nb), dtype).at[:T].set(mags)
        wm = w[..., None] * m.reshape(Tp // L, L, nb)
        S = jnp.einsum("lj,cjb->clb", tri, wm, precision=jax.lax.Precision.HIGHEST)
        b_el = p[:, -1, None] * S[:, -1]
        _, Bc = jax.lax.associative_scan(comb, (a_el, b_el))
        A0s = jnp.concatenate([jnp.zeros((1, nb), dtype), Bc[:-1]], axis=0)
        # note (r4): gathering p/A0s/S per latch row instead of materializing
        # A measured SLOWER (three take_along_axis lower worse than one dense
        # fused elementwise + one gather) -- keep the dense form
        A = p[..., None] * (A0s[:, None, :] + S)  # (T/L, L, nb)
        A = A.reshape(Tp, nb)
        ns = jnp.where(
            have, jnp.take_along_axis(A, gidx, axis=0), jnp.zeros((), dtype)
        )
        outs.append(ns[:T])
    return tuple(outs)


def _noise_latch_closed_form(speech, mags, chunk: int = 64):
    """Single-plane wrapper over :func:`_noise_latch_parts`."""
    return _noise_latch_parts(speech, (mags,), chunk=chunk)[0]


@functools.lru_cache(maxsize=None)
def _dft_matrices():
    """Real-DFT (1024 -> 513 bins) and inverse matrices as numpy f32.

    The 1024-pt transform as two (1024, 513) matmuls; the engine's dot
    algorithm (:func:`jeicyboodsp_tpu.ops.dft.precision_of`) sets its
    accuracy.
    """
    n = FFT_SIZE
    k = np.arange(n)[:, None] * np.arange(n // 2 + 1)[None, :]
    ang = -2.0 * np.pi * k / n
    fwd_re = np.cos(ang).astype(np.float32)
    fwd_im = np.sin(ang).astype(np.float32)
    # inverse real FFT: y[t] = (1/N) sum_k w_k (re_k cos - im_k sin)
    wk = np.full(n // 2 + 1, 2.0)
    wk[0] = wk[-1] = 1.0
    inv_re = (wk[:, None] * np.cos(-ang.T) / n).astype(np.float32)
    inv_im = (wk[:, None] * np.sin(-ang.T) / n).astype(np.float32)
    return fwd_re, fwd_im, inv_re, inv_im


def frame_transform(frames, dtype, real_fft: bool = False, fft_engine: str = "xla"):
    """w * [prev, cur] -> complex spectrum (batched).

    ``real_fft`` computes only the 513 non-redundant bins (the input is
    real); mathematically identical, half the bandwidth/compute.
    ``fft_engine="mxu"``/``"mxu3"`` (f32 only) evaluates the DFT as two
    matmuls with that engine's dot algorithm.
    """
    w = hamming_ref(FFT_SIZE, dtype)
    windowed = frames.astype(dtype) * w
    if fft_engine.startswith("mxu"):
        from jeicyboodsp_tpu.ops.dft import precision_of

        fwd_re, fwd_im, _, _ = _dft_matrices()
        hi = precision_of(fft_engine)
        re = jnp.dot(windowed, jnp.asarray(fwd_re), precision=hi)
        im = jnp.dot(windowed, jnp.asarray(fwd_im), precision=hi)
        return jax.lax.complex(re, im)
    if real_fft:
        return jnp.fft.rfft(windowed)
    ctype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    return jnp.fft.fft(windowed.astype(ctype))


def gain_and_resynth(
    X, ns, mode: str, real_fft: bool = False, resynth: str = "trig", fft_engine: str = "xla"
):
    """Per-bin gain with saved phase -> time-domain frame (batched IFFT).

    ``resynth="trig"`` reproduces the reference's atan2/cos/sin phase
    save/restore literally; ``"ratio"`` uses the identity
    amp*e^{i phase} == X * (amp/|X|), removing three transcendentals per
    bin (identical values up to rounding, including the NaN cases: a zero
    bin makes the ratio NaN exactly where the reference's gain went NaN).
    """
    mags = jnp.abs(X)
    if mode == "wiener":
        P = X.real ** 2 + X.imag ** 2
        v = ns ** 2 / P  # 0/0 -> nan, k/0 -> inf, as the C code does
        v = jnp.where(v >= 1.0, 1.0, v)  # NaN stays NaN (matches C)
        gain = 1.0 - v  # == amp / |X|
        amp = jnp.abs(jnp.sqrt(P)) * gain
    elif mode == "specsub":
        amp = mags - ns
        gain = amp / mags
    else:
        raise ValueError(mode)
    if resynth == "ratio":
        Y = X * gain.astype(X.real.dtype)
    else:
        phase = jnp.arctan2(X.imag, X.real)
        Y = (amp * jnp.cos(phase) + 1j * amp * jnp.sin(phase)).astype(X.dtype)
    if fft_engine.startswith("mxu"):
        from jeicyboodsp_tpu.ops.dft import precision_of

        _, _, inv_re, inv_im = _dft_matrices()
        hi = precision_of(fft_engine)
        return jnp.dot(Y.real, jnp.asarray(inv_re), precision=hi) - jnp.dot(
            Y.imag, jnp.asarray(inv_im), precision=hi
        )
    if real_fft:
        return jnp.fft.irfft(Y, FFT_SIZE)
    return jnp.fft.ifft(Y).real


@functools.lru_cache(maxsize=None)
def _dft_mats_aligned():
    """512-aligned DFT bases: 512-column matmuls + rank-1 Nyquist terms.

    Splitting the Nyquist bin out (its sin column is exactly zero) keeps
    every GEMM at power-of-two 512/1024 shapes.
    The inverse additionally exploits y[n-s] symmetry -- cos columns are
    even, sin columns odd in s -- so TWO (513->512)-shaped matmuls (u, v)
    yield all 1024 output samples: y[0:512] = u - v, y[512+s] from
    flip(u + v).  Halves the inverse FLOPs vs the dense (513, 1024) form.
    """
    n = FFT_SIZE
    kk = np.arange(n)[:, None] * np.arange(n // 2 + 1)[None, :]
    ang = -2.0 * np.pi * kk / n  # (1024, 513)
    # Hamming window folded into the forward bases: w*[prev,cur] @ C becomes
    # prev @ WC[:512] + cur @ WC[512:], and since prev is just cur shifted by
    # one row, the whole framing+windowing stage disappears into a row shift
    i = np.arange(n)
    ham = (0.54 - 0.46 * np.cos(2.0 * float(REF_PI) * i / (n - 1)))[:, None]
    C = (ham * np.cos(ang)).astype(np.float32)
    S = (ham * np.sin(ang)).astype(np.float32)
    wk = np.full(n // 2 + 1, 2.0)
    wk[0] = wk[-1] = 1.0
    ks = np.arange(n // 2 + 1)[:, None] * np.arange(n // 2)[None, :]
    ang2 = 2.0 * np.pi * ks / n
    UC = (wk[:, None] * np.cos(ang2) / n).astype(np.float32)  # (513, 512)
    VS = (wk[:, None] * np.sin(ang2) / n).astype(np.float32)  # (513, 512)
    y512col = (wk * np.cos(np.pi * np.arange(n // 2 + 1)) / n).astype(np.float32)
    return dict(
        WC=np.ascontiguousarray(C[:, :512]), WS=np.ascontiguousarray(S[:, :512]),
        nyq=np.ascontiguousarray(C[:, 512]),
        UC512=UC[:512], VS512=VS[:512],  # VS[512] is exactly zero
        u_nyq=np.ascontiguousarray(UC[512]), y512col=y512col,
    )


def _enhance_fast_mxu(blocks, mode, dtype, precision, emit_all):
    """The matmul-DFT speed path: 512-aligned GEMMs, symmetry-halved
    inverse, closed-form noise latch.  Same math as the generic path (ratio
    resynthesis) up to rounding; SNR contract asserted by tests/bench."""
    T = blocks.shape[0]
    M = _dft_mats_aligned()
    WC, WS = jnp.asarray(M["WC"], dtype), jnp.asarray(M["WS"], dtype)
    nyq = jnp.asarray(M["nyq"], dtype)
    UC512, VS512 = jnp.asarray(M["UC512"], dtype), jnp.asarray(M["VS512"], dtype)
    u_nyq, y512col = jnp.asarray(M["u_nyq"], dtype), jnp.asarray(M["y512col"], dtype)

    prev = jnp.concatenate([jnp.zeros((1, BLOCK_LEN), blocks.dtype), blocks[:-1]], axis=0)
    frames = jnp.concatenate([prev, blocks], axis=1).astype(dtype)  # window is
    # folded into WC/WS/nyq, so the frame feeds the GEMMs directly

    re = jnp.dot(frames, WC, precision=precision)  # (T, 512)
    im = jnp.dot(frames, WS, precision=precision)
    # the rank-1 Nyquist terms are matrix-vector products: float32 dots at
    # any engine (the CPU backend implements bf16x3 only for matmuls)
    hi = jax.lax.Precision.HIGHEST
    re_n = jnp.dot(frames, nyq, precision=hi)  # (T,) Nyquist (im == 0)

    P512 = re * re + im * im
    mag512 = jnp.sqrt(P512)
    mag_n = jnp.abs(re_n)
    mags = jnp.concatenate([mag512, mag_n[:, None]], axis=-1)  # (T, 513)

    speech = vad_flags(blocks, dtype)
    ns = _noise_latch_closed_form(speech, mags)
    ns512, ns_n = ns[:, :512], ns[:, 512]

    if mode == "wiener":
        v512 = ns512 ** 2 / P512  # 0/0 -> NaN, as the reference
        g512 = 1.0 - jnp.where(v512 >= 1.0, 1.0, v512)
        v_n = ns_n ** 2 / (re_n * re_n)
        g_n = 1.0 - jnp.where(v_n >= 1.0, 1.0, v_n)
    elif mode == "specsub":
        g512 = (mag512 - ns512) / mag512
        g_n = (mag_n - ns_n) / mag_n
    else:
        raise ValueError(mode)
    Yre = re * g512
    Yim = im * g512
    Yre_n = re_n * g_n

    u = jnp.dot(Yre, UC512, precision=precision) + Yre_n[:, None] * u_nyq
    v = jnp.dot(Yim, VS512, precision=precision)
    head = u - v  # y[0:512]
    y512 = jnp.dot(Yre, y512col[:512], precision=hi) + Yre_n * y512col[512]
    tail = jnp.concatenate(  # y[512:1024] = [y512, flip(u + v)[1:]]
        [y512[:, None], jnp.flip((u + v)[:, 1:], axis=-1)], axis=-1
    )

    tail_prev = jnp.concatenate([jnp.zeros((1, BLOCK_LEN), head.dtype), tail[:-1]], axis=0)
    t_idx = jnp.arange(T)
    valid = t_idx >= 1
    ola = jnp.where(
        valid[:, None], head + jnp.where((t_idx >= 2)[:, None], tail_prev, 0.0), 0.0
    )
    out = c_short_jnp(ola)
    write_mask = t_idx >= 2
    if not emit_all:
        out = jnp.where(write_mask[:, None], out, 0)
    return out, write_mask


@functools.partial(
    jax.jit,
    static_argnames=(
        "mode", "dtype", "use_assoc_scan", "emit_all", "real_fft", "resynth", "fft_engine",
    ),
)
def enhance_blocks(
    blocks,
    mode: str = "wiener",
    dtype=jnp.float64,
    use_assoc_scan: bool = False,
    emit_all: bool = False,
    real_fft: bool = False,
    resynth: str = "trig",
    fft_engine: str = "xla",
):
    """Run the full chain over (T, 512) int16 blocks.

    Returns (out, write_mask): out is (T, 512) int16; blocks with
    write_mask False are not part of the reference's output stream
    (warm-up frames t<2).  With ``emit_all`` the warm-up rows are zeros.
    """
    T = blocks.shape[0]
    fdtype = dtype

    from jeicyboodsp_tpu.ops.dft import check_engine, precision_of

    check_engine(fft_engine)
    if fft_engine.startswith("mxu") and resynth == "ratio":
        return _enhance_fast_mxu(
            blocks, mode, fdtype, precision_of(fft_engine), emit_all
        )

    prev = jnp.concatenate([jnp.zeros((1, BLOCK_LEN), blocks.dtype), blocks[:-1]], axis=0)
    X = frame_transform(
        jnp.concatenate([prev, blocks], axis=1), fdtype, real_fft=real_fft, fft_engine=fft_engine
    )
    mags = jnp.abs(X)

    speech = vad_flags(blocks, fdtype)
    noise_fn = _noise_assoc_scan if use_assoc_scan else _noise_scan
    ns = noise_fn(speech, mags)

    y = gain_and_resynth(
        X, ns, mode, real_fft=real_fft, resynth=resynth, fft_engine=fft_engine
    )

    # overlap-add: out[t] = y[t][:512] + y[t-1][512:]; y[t=0] does not exist
    # (first filter call returns before transforming, :174-179)
    head = y[:, :BLOCK_LEN]
    tail_prev = jnp.concatenate([jnp.zeros((1, BLOCK_LEN), fdtype), y[:-1, BLOCK_LEN:]], axis=0)
    t_idx = jnp.arange(T)
    valid = t_idx >= 1  # filter produced a frame
    ola = jnp.where(valid[:, None], head + jnp.where((t_idx >= 2)[:, None], tail_prev, 0.0), 0.0)
    out = c_short_jnp(ola)
    write_mask = t_idx >= 2
    if not emit_all:
        out = jnp.where(write_mask[:, None], out, 0)
    return out, write_mask


def stream_init_state(dtype=jnp.float64):
    """Streaming carry for chunked processing / checkpoint-resume.

    Fields mirror the reference statics: noise counter + running average +
    latched spectrum (EstimateNoiseSpectrum), previous block (the shared
    keep buffer), previous synthesis tail (the overlap buffer), and the
    global block index (the write warm-up gate)."""
    return {
        "cnt": jnp.zeros((), jnp.int32),
        "avg": jnp.zeros((FFT_SIZE,), dtype),
        "latched": jnp.zeros((FFT_SIZE,), dtype),
        "prev_block": jnp.zeros((BLOCK_LEN,), jnp.int16),
        "prev_tail": jnp.zeros((BLOCK_LEN,), dtype),
        "t": jnp.zeros((), jnp.int32),
    }


@functools.partial(jax.jit, static_argnames=("mode", "dtype"))
def enhance_chunk(state, blocks, mode: str = "wiener", dtype=jnp.float64):
    """Process a chunk of (Tc, 512) blocks from an explicit carried state.

    Returns (out (Tc,512) int16, write_mask (Tc,), new_state).  Chunked
    processing with carried state equals one-shot batch processing exactly
    (asserted in tests); the state pytree is what checkpoints persist.
    """
    Tc = blocks.shape[0]
    prev = jnp.concatenate([state["prev_block"][None], blocks[:-1]], axis=0)
    X = frame_transform(jnp.concatenate([prev, blocks], axis=1), dtype)
    mags = jnp.abs(X)
    speech = vad_flags(blocks, dtype)

    def step(carry, inp):
        cnt, avg, latched = carry
        sp, m = inp
        cnt = jnp.where(sp, 0, cnt + 1)
        run = (~sp) & (cnt >= 2)
        avg2 = jnp.where(run, jnp.where(cnt >= 3, (avg + m) / 2.0, avg + m), avg)
        latched2 = jnp.where(run & (cnt == NOISE_FRAMES), avg2, latched)
        return (cnt, avg2, latched2), latched2

    (cnt, avg, latched), ns = jax.lax.scan(
        step, (state["cnt"], state["avg"], state["latched"]), (speech, mags)
    )
    y = gain_and_resynth(X, ns, mode)
    gidx = state["t"] + jnp.arange(Tc)
    head = y[:, :BLOCK_LEN]
    tails = jnp.concatenate([state["prev_tail"][None], y[:-1, BLOCK_LEN:]], axis=0)
    valid = gidx >= 1
    use_tail = gidx >= 2
    ola = jnp.where(valid[:, None], head + jnp.where(use_tail[:, None], tails, 0.0), 0.0)
    out = jnp.where(use_tail[:, None], c_short_jnp(ola), 0)
    new_state = {
        "cnt": cnt,
        "avg": avg,
        "latched": latched,
        "prev_block": blocks[-1],
        "prev_tail": y[-1, BLOCK_LEN:],
        "t": state["t"] + Tc,
    }
    return out, use_tail, new_state


def run_stream(
    x, mode: str = "wiener", dtype=jnp.float64, use_assoc_scan: bool = False,
    fft_engine: str = "xla",
):
    """Host convenience: full signal in, reference-equivalent byte stream out."""
    x = np.asarray(x, dtype=np.int16)
    if len(x) == 0:  # the reference emits nothing on an empty payload
        return np.zeros(0, np.int16)
    T = len(x) // BLOCK_LEN
    rem = len(x) - T * BLOCK_LEN
    blocks = x[: T * BLOCK_LEN].reshape(T, BLOCK_LEN)
    if rem:
        last = np.concatenate([x[T * BLOCK_LEN :], blocks[-1][rem:] if T else np.zeros(BLOCK_LEN - rem, np.int16)])
        blocks = np.concatenate([blocks, last[None]], axis=0)
    # mxu engines: ratio resynthesis is the documented fast-path contract
    # (identical values to trig up to rounding, incl. the NaN cases) and
    # selects the 512-aligned GEMM form
    resynth = "ratio" if fft_engine.startswith("mxu") else "trig"
    out, mask = enhance_blocks(
        jnp.asarray(blocks), mode=mode, dtype=dtype, use_assoc_scan=use_assoc_scan,
        real_fft=fft_engine.startswith("mxu"), fft_engine=fft_engine,
        resynth=resynth,
    )
    out = np.asarray(out)
    mask = np.asarray(mask)
    return out[mask].reshape(-1)

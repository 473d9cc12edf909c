"""7-band graphic EQ as a JAX op.

Reference behavior: ``7Band_GEQ.cpp`` (see :mod:`jeicyboodsp_tpu.oracle.geq`
for the full quirk list).  Two execution modes:

- ``geq_apply``: *compat* mode.  The reference quantizes the direct-form-I
  output to int16 inside the feedback loop (``7Band_GEQ.cpp:284``), making the
  recursion integer-valued and strictly sequential.  We express it as a
  ``lax.scan`` over samples carrying the 2-sample input/output histories of
  all 7 bands; throughput comes from ``vmap`` over independent streams
  (batch) rather than intra-stream parallelism.

- ``geq_apply_fast``: *fast* mode.  Drops the in-loop quantization (pure
  linear cascade), which makes each biquad a 2-dim linear state-space
  recursion that XLA can run as one associative scan per band -- massively
  parallel over time.  Output differs from the reference by the (audible)
  requantization the reference applies; this is the speed-of-light path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.oracle.geq import (  # coefficient math is host-side
    BLOCK_LEN,
    CENTER_FREQS,
    GAINS_DB,
    TOTAL_BANDS,
    calc_coefficients,
)
from jeicyboodsp_tpu.utils.cnum import c_short_jnp

# float32 dots stay float32 on the GPU (its default f32 dot is TF32)
_HI = jax.lax.Precision.HIGHEST
_mm = functools.partial(jnp.matmul, precision=_HI)


def init_state():
    """Per-band int16 keep buffers: x history (2,) + per-band y history (7,2)."""
    return {
        "xh": jnp.zeros((2,), jnp.int32),
        "yh": jnp.zeros((TOTAL_BANDS, 2), jnp.int32),
    }


@functools.partial(jax.jit, static_argnames=("dtype",))
def geq_apply(x, b, a, state, dtype=jnp.float32):
    """Compat-mode cascade. x: int (N,) -> (y int16 (N,), new_state).

    Exactly reproduces the reference recursion
    ``y[k][n] = short(b0*u[n] + b1*u[n-1] + b2*u[n-2] - a1*y[n-1] - a2*y[n-2])``
    where u is band k-1's quantized output (7Band_GEQ.cpp:279-284).
    """
    b = jnp.asarray(b, dtype)
    a = jnp.asarray(a, dtype)

    def step(carry, xn):
        xh, yh = carry["xh"], carry["yh"]
        new_yh = []
        u2, u1, u0 = xh[0], xh[1], xn  # u[n-2], u[n-1], u[n]
        for k in range(TOTAL_BANDS):
            # accumulate in the C loop's exact order (7Band_GEQ.cpp:279-283):
            # the int16 truncation feedback makes rounding order observable.
            # optimization_barrier pins each product to a separately-rounded
            # multiply -- XLA would otherwise contract mul+add into fma,
            # whose different rounding flips truncation boundaries that then
            # propagate through the integer feedback.
            ob = jax.lax.optimization_barrier
            acc = ob(b[k, 2] * u2.astype(dtype))
            acc = ob(acc - ob(a[k, 2] * yh[k, 0].astype(dtype)))
            acc = ob(acc + ob(b[k, 1] * u1.astype(dtype)))
            acc = ob(acc - ob(a[k, 1] * yh[k, 1].astype(dtype)))
            acc = acc + ob(b[k, 0] * u0.astype(dtype))
            y = c_short_jnp(acc).astype(jnp.int32)
            new_yh.append(jnp.stack([yh[k, 1], y]))
            u2, u1, u0 = yh[k, 0], yh[k, 1], y  # next band's input history
        carry = {
            "xh": jnp.stack([xh[1], xn]),
            "yh": jnp.stack(new_yh),
        }
        return carry, u0  # u0 is band-6 output after the loop

    new_state, y = jax.lax.scan(step, state, x.astype(jnp.int32))
    return y.astype(jnp.int16), new_state


def geq_coefficients(gains_db=GAINS_DB, center_freqs=CENTER_FREQS, compat=True):
    b, a = calc_coefficients(gains_db=gains_db, center_freqs=center_freqs, compat=compat)
    return np.asarray(b), np.asarray(a)


# ---------------------------------------------------------------------------
# fast path: linear cascade without in-loop quantization
# ---------------------------------------------------------------------------


def _biquad_linear(x, b0, b1, b2, a1, a2):
    """One biquad as an associative scan over 2x2 state-space transitions.

    y[n] depends linearly on (y[n-1], y[n-2]); write s[n] = (y[n], y[n-1]):
    s[n] = A s[n-1] + B f[n] with A = [[-a1, -a2], [1, 0]], f[n] the FIR part.
    The affine recursion composes associatively, so XLA evaluates it in
    O(log N) depth.
    """
    dtype = x.dtype
    f = b0 * x + b1 * jnp.roll(x, 1).at[0].set(0) + b2 * jnp.roll(x, 2).at[:2].set(0)
    A = jnp.array([[-a1, -a2], [1.0, 0.0]], dtype)
    As = jnp.broadcast_to(A, (x.shape[0], 2, 2))
    Bs = jnp.stack([f, jnp.zeros_like(f)], axis=-1)

    def combine(l, r):
        Al, bl = l
        Ar, br = r
        return _mm(Ar, Al), jnp.einsum("...ij,...j->...i", Ar, bl, precision=_HI) + br

    _, s = jax.lax.associative_scan(combine, (As, Bs))
    return s[:, 0]


@functools.partial(jax.jit, static_argnames=("dtype",))
def geq_apply_fast(x, b, a, dtype=jnp.float32):
    """Fast-mode cascade: float linear filtering, no int16 feedback.

    x: (..., N) float or int; returns float32 (..., N).
    """
    y = x.astype(dtype)
    b = jnp.asarray(b, dtype)
    a = jnp.asarray(a, dtype)
    fn = _biquad_linear
    for _ in range(y.ndim - 1):
        fn = jax.vmap(fn, in_axes=(0, None, None, None, None, None))
    for k in range(TOTAL_BANDS):
        y = fn(y, b[k, 0], b[k, 1], b[k, 2], a[k, 1], a[k, 2])
    return y


def stream_blocks(x, gains_db=GAINS_DB, compat=True, dtype=jnp.float64, use_native=True):
    """Host-level convenience: run a whole signal block-by-block (512) and
    return the concatenated int16 output, matching oracle.geq.run().

    For f64 compat the native C++ kernel is preferred: it is bit-exact
    against the reference (XLA's fma contraction can flip truncation
    boundaries in the quantized feedback; see module docstring)."""
    b, a = geq_coefficients(gains_db=gains_db, compat=compat)
    xx = np.asarray(x, np.int16)
    n_full, rem = divmod(len(xx), BLOCK_LEN)
    if rem:  # stale-tail fread semantics: pad from the previous block
        prev = (
            xx[(n_full - 1) * BLOCK_LEN : n_full * BLOCK_LEN]
            if n_full
            else np.zeros(BLOCK_LEN, np.int16)
        )
        xx = np.concatenate([xx, prev[rem:]])
    if len(xx) == 0:  # the reference emits nothing on an empty payload
        return np.zeros(0, np.int16)
    if use_native and dtype == jnp.float64:
        from jeicyboodsp_tpu import native

        if native.available():
            ki = np.zeros((TOTAL_BANDS, 2), np.int16)
            ko = np.zeros((TOTAL_BANDS, 2), np.int16)
            return native.geq_process(xx, b, a, ki, ko)
    # the carries run straight through block boundaries, so one scan over
    # the padded signal equals the reference's block loop
    y, _ = geq_apply(jnp.asarray(xx), b, a, init_state(), dtype=dtype)
    return np.asarray(y)

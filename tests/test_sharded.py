"""Multi-device equivalence: sharded pipelines == single-device, on the
8-virtual-device CPU mesh (SURVEY §4 distributed test strategy)."""

import jax
import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.ops import enhance as E
from jeicyboodsp_tpu.ops import fastconv as FC
from jeicyboodsp_tpu.ops import mvdr as MV
from jeicyboodsp_tpu.parallel import make_mesh
from jeicyboodsp_tpu.parallel import sharded as S


def _mesh():
    return make_mesh(axis_names=("time",), shape=(len(jax.devices()),))


def _assert_lsb_equal(want, got, frac=0.01):
    """Sharded == single-device up to +-1 int16 LSB on <1% of samples: the
    associative prefix recombines floating-point sums in a different order,
    and the final truncation exposes ulp-level differences."""
    d = want.astype(np.int64) - got.astype(np.int64)
    assert np.abs(d).max() <= 1, np.abs(d).max()
    assert (d != 0).mean() <= frac, (d != 0).mean()


def test_devices_available():
    assert len(jax.devices()) == 8, jax.devices()


def test_mvdr_sharded_bins_matches_mxu_engine(rng):
    """Tensor-parallel (frequency-bin) MVDR == unsharded matmul-DFT engine up
    to f32 reduction-order rounding (+-1 int16 truncation flips)."""
    import jax.numpy as jnp

    from jeicyboodsp_tpu.ops.mvdr import mvdr_blocks
    from jeicyboodsp_tpu.parallel import make_mesh
    from jeicyboodsp_tpu.parallel.sharded import mvdr_sharded_bins

    n = 512 * 16
    t = np.arange(n) / 16000
    speech = 6000 * np.sin(2 * np.pi * 400 * t) * (((t > 0.12) & (t < 0.2)) | (t > 0.3))
    xl = np.clip(speech + rng.normal(0, 15, n), -32768, 32767).astype(np.int16)
    xr = np.clip(0.8 * speech + rng.normal(0, 15, n), -32768, 32767).astype(np.int16)
    bl = jnp.asarray(xl.reshape(-1, 512))
    br = jnp.asarray(xr.reshape(-1, 512))

    want, wm = mvdr_blocks(bl, br, 0.0, dtype=jnp.float32, fft_engine="mxu3")
    mesh = make_mesh((8,), ("model",))
    got, gm = mvdr_sharded_bins(bl, br, mesh, 0.0, axis="model")
    np.testing.assert_array_equal(np.asarray(wm), np.asarray(gm))
    w = np.asarray(want).astype(np.int64)
    g = np.asarray(got).astype(np.int64)
    d = np.abs(w - g)
    assert d.max() <= 1 and (d != 0).mean() < 0.01, (d.max(), (d != 0).mean())


def test_enhance_sharded_exact(rng):
    n = 512 * 32
    t = np.arange(n) / 16000
    speech = 5000 * np.sin(2 * np.pi * 313 * t) * (((t > 0.35) & (t < 0.6)) | (t > 0.8))
    x = np.clip(speech + rng.normal(0, 20, n), -32768, 32767).astype(np.int16)
    blocks = jnp.asarray(x.reshape(-1, 512))
    for mode in ("wiener", "specsub"):
        want, wmask = E.enhance_blocks(blocks, mode=mode)
        got, gmask = S.enhance_sharded(blocks, _mesh(), mode=mode)
        np.testing.assert_array_equal(np.asarray(wmask), np.asarray(gmask))
        _assert_lsb_equal(np.asarray(want), np.asarray(got))


def test_fastconv_sharded_exact(rng):
    n = 1024 * 16
    x = np.clip(rng.normal(0, 2000, n), -32768, 32767).astype(np.int16)
    blocks = jnp.asarray(x.reshape(-1, 1024))
    Hr, Hi = FC.filter_spectrum()
    want = FC.fastconv_blocks(blocks, Hr, Hi)  # (T-7, 1024)
    got, mask = S.fastconv_sharded(blocks, Hr, Hi, _mesh())
    got = np.asarray(got)[np.asarray(mask)]
    _assert_lsb_equal(np.asarray(want), got)


def test_bnlms_sharded_exact(rng):
    """Session-data-parallel BNLMS == vmapped single-device (bitwise: no
    collectives touch the recursion, each session stays on one device)."""
    import functools

    from jeicyboodsp_tpu.ops import nlms as NL

    B, T = 8, 4
    far = np.clip(rng.normal(0, 2000, (B, T, 1024)), -32768, 32767).astype(np.int16)
    near = np.clip(
        0.5 * far + rng.normal(0, 100, (B, T, 1024)), -32768, 32767
    ).astype(np.int16)
    st = jax.vmap(lambda _: NL.bnlms_init_state(jnp.float64))(jnp.arange(B))
    want_e, want_r, _ = jax.vmap(functools.partial(NL.bnlms_apply, dtype=jnp.float64))(
        jnp.asarray(far), jnp.asarray(near), st
    )
    mesh = make_mesh((8,), ("data",))
    got_e, got_r = S.bnlms_sharded(jnp.asarray(far), jnp.asarray(near), mesh)
    np.testing.assert_array_equal(np.asarray(want_e), np.asarray(got_e))
    np.testing.assert_array_equal(np.asarray(want_r), np.asarray(got_r))


def test_bnlms_sharded_time_matches_unsharded(rng):
    """TIME-sharded affine BNLMS == the unsharded associative-scan form up
    to f32 reduction-order rounding (+-1 LSB flips on few samples)."""
    from jeicyboodsp_tpu.ops import nlms as NL

    T = 16
    far = np.clip(rng.normal(0, 3000, (T, 1024)), -32768, 32767).astype(np.int16)
    echo = 0.5 * np.roll(far.reshape(-1), 5).reshape(T, 1024)
    near = np.clip(echo + rng.normal(0, 150, (T, 1024)), -32768, 32767).astype(np.int16)
    want_e, want_r = NL.bnlms_apply_timeparallel(
        jnp.asarray(far), jnp.asarray(near), dtype=jnp.float32
    )
    got_e, got_r = S.bnlms_sharded_time(
        jnp.asarray(far), jnp.asarray(near), _mesh(), dtype=jnp.float32
    )
    for w, g in ((want_e, got_e), (want_r, got_r)):
        d = np.asarray(w).astype(np.int64) - np.asarray(g).astype(np.int64)
        assert np.abs(d).max() <= 1 and (d != 0).mean() < 0.01, (
            np.abs(d).max(), (d != 0).mean(),
        )


def test_nlms_sharded_exact(rng):
    import functools

    from jeicyboodsp_tpu.ops import nlms as NL

    B, N = 8, 1024
    far = np.clip(rng.normal(0, 2000, (B, N)), -32768, 32767).astype(np.int16)
    near = np.clip(
        0.5 * far + rng.normal(0, 100, (B, N)), -32768, 32767
    ).astype(np.int16)
    st = jax.vmap(lambda _: NL.nlms_init_state(jnp.float64))(jnp.arange(B))
    want_e, want_r, _ = jax.vmap(
        functools.partial(NL.nlms_apply, dtype=jnp.float64, compat=True)
    )(jnp.asarray(far), jnp.asarray(near), st)
    mesh = make_mesh((8,), ("data",))
    got_e, got_r = S.nlms_sharded(jnp.asarray(far), jnp.asarray(near), mesh)
    np.testing.assert_array_equal(np.asarray(want_e), np.asarray(got_e))
    np.testing.assert_array_equal(np.asarray(want_r), np.asarray(got_r))


def test_mvdr_sharded_exact(rng):
    n = 512 * 16
    t = np.arange(n) / 16000
    speech = 6000 * np.sin(2 * np.pi * 400 * t) * (t > 0.25)
    xl = np.clip(speech + rng.normal(0, 15, n), -32768, 32767).astype(np.int16)
    xr = np.clip(0.8 * speech + rng.normal(0, 15, n), -32768, 32767).astype(np.int16)
    bl = jnp.asarray(xl.reshape(-1, 512))
    br = jnp.asarray(xr.reshape(-1, 512))
    want, wmask = MV.mvdr_blocks(bl, br)
    got, gmask = S.mvdr_sharded(bl, br, _mesh())
    np.testing.assert_array_equal(np.asarray(wmask), np.asarray(gmask))
    _assert_lsb_equal(np.asarray(want), np.asarray(got))


def test_data_parallel_geq_fast(rng):
    """Batch axis sharding of the fast GEQ path: pjit over a data mesh."""
    from jeicyboodsp_tpu.ops import geq as G

    mesh = make_mesh(axis_names=("data",), shape=(8,))
    x = rng.normal(0, 1000, (8, 2048)).astype(np.float32)
    b, a = G.geq_coefficients()
    want = G.geq_apply_fast(jnp.asarray(x), b, a, dtype=jnp.float32)
    xs = jax.device_put(jnp.asarray(x), S.data_parallel_sharding(mesh))
    got = G.geq_apply_fast(xs, b, a, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(want), np.asarray(got), rtol=1e-5, atol=1e-3)


def test_em_step_sharded_matches_local():
    from jeicyboodsp_tpu.models.gmm import em_step

    rng = np.random.default_rng(31)
    centers = rng.normal(0, 4, (4, 12))
    frames = np.array([centers[i % 4] + rng.normal(0, 2.0, 12) for i in range(128)])
    mask = np.ones(128, bool)
    alpha = np.full(4, 0.25)
    mean = frames[np.arange(4) * 4]
    cov = np.stack([np.eye(12) * 4.0] * 4)

    want = em_step(jnp.asarray(frames), jnp.asarray(mask), jnp.asarray(alpha), jnp.asarray(mean), jnp.asarray(cov))
    mesh = make_mesh(axis_names=("data",), shape=(8,))
    got = S.em_step_sharded(
        jnp.asarray(frames), jnp.asarray(mask), jnp.asarray(alpha), jnp.asarray(mean), jnp.asarray(cov), mesh
    )
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(w), np.asarray(g), rtol=1e-10, atol=1e-12)


def test_enhance_sharded2d_exact(rng):
    """(B, T) streams over a (data=2, time=4) mesh == per-stream batch op."""
    B, T = 4, 32
    xs = []
    for bi in range(B):
        n = T * 512
        t = np.arange(n) / 16000
        speech = 5000 * np.sin(2 * np.pi * (200 + 100 * bi) * t) * (t > 0.3 + 0.1 * bi)
        xs.append(np.clip(speech + rng.normal(0, 20, n), -32768, 32767).astype(np.int16))
    blocks = jnp.asarray(np.stack([x.reshape(T, 512) for x in xs]))
    mesh = make_mesh((2, 4), ("data", "time"))
    got, gmask = S.enhance_sharded2d(blocks, mesh, dtype=jnp.float64)
    for bi in range(B):
        want, wmask = E.enhance_blocks(blocks[bi], mode="wiener", dtype=jnp.float64)
        np.testing.assert_array_equal(np.asarray(wmask), np.asarray(gmask)[bi][:, 0] if np.asarray(gmask)[bi].ndim > 1 else np.asarray(gmask)[bi])
        _assert_lsb_equal(np.asarray(want), np.asarray(got)[bi])


def test_geq_sharded_matches_fast(rng):
    """Time-sharded GEQ linear cascade == geq_apply_fast (f64), closing the
    last non-AEC sequential-state pipeline without a sharded variant."""
    from jeicyboodsp_tpu.ops.geq import geq_apply_fast, geq_coefficients

    n = 512 * 16
    x = np.clip(rng.normal(0, 3000, n), -32768, 32767).astype(np.int16)
    b, a = geq_coefficients()
    want = np.asarray(geq_apply_fast(jnp.asarray(x), b, a, dtype=jnp.float64))
    got = np.asarray(S.geq_sharded(jnp.asarray(x), b, a, _mesh(), dtype=jnp.float64))
    # different reduction grouping across shards: ulp-level relative error,
    # amplified through the 44 Hz shelf's near-unity pole
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-5)

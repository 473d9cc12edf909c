"""Chunked stateful streaming == batch; checkpoint/resume; aux utils."""

import numpy as np

from jeicyboodsp_tpu.io.stream import EnhanceSession
from jeicyboodsp_tpu.oracle import enhance as oenh


def _signal(rng, blocks=24):
    n = blocks * 512
    t = np.arange(n) / 16000
    speech = 5000 * np.sin(2 * np.pi * 313 * t) * (t > 0.4)
    return np.clip(speech + rng.normal(0, 20, n), -32768, 32767).astype(np.int16)


def test_chunked_equals_oracle(rng):
    x = _signal(rng)
    want = oenh.run(x, "wiener")
    sess = EnhanceSession("wiener")
    outs = []
    blocks = x.reshape(-1, 512)
    for start in range(0, len(blocks), 5):  # ragged chunking
        outs.append(sess.process(blocks[start : start + 5]))
    got = np.concatenate(outs)
    np.testing.assert_array_equal(want, got)


def test_checkpoint_resume(rng, tmp_path):
    x = _signal(rng)
    blocks = x.reshape(-1, 512)
    ckpt = str(tmp_path / "state.npz")

    sess = EnhanceSession("wiener")
    a1 = sess.process(blocks[:10])
    sess.checkpoint(ckpt)
    a2 = sess.process(blocks[10:])

    sess2 = EnhanceSession("wiener")
    sess2.restore(ckpt)
    assert sess2.sample_offset == 10 * 512
    b2 = sess2.process(blocks[10:])
    np.testing.assert_array_equal(a2, b2)


def test_metrics_and_roofline():
    from jeicyboodsp_tpu.utils.metrics import Metrics, snr_db
    from jeicyboodsp_tpu.utils.profiling import enhance_chain_roofline

    m = Metrics()
    m.count("blocks", 5)
    m.gauge("snr_db", 80.0)
    with m.timer("step"):
        pass
    r = m.report()
    assert r["counters"]["blocks"] == 5 and "step" in r["timings"]
    assert snr_db([1.0, 2.0], [1.0, 2.0]) == float("inf")

    roof = enhance_chain_roofline().bound("NVIDIA H100 80GB HBM3")
    assert roof["speed_of_light_samples_per_s"] > 1e9  # the chain's ceiling


def test_checked_guard():
    import jax.numpy as jnp

    from jeicyboodsp_tpu.utils.debug import assert_all_finite

    assert_all_finite({"a": jnp.ones(3)})
    try:
        assert_all_finite({"a": jnp.array([1.0, jnp.nan])})
        raise AssertionError("should have raised")
    except FloatingPointError:
        pass


def test_geq_session_checkpoint(rng, tmp_path):
    from jeicyboodsp_tpu.io.stream import GEQSession
    from jeicyboodsp_tpu.oracle import geq as og

    x = np.clip(rng.normal(0, 3000, 2048), -32768, 32767).astype(np.int16)
    s = GEQSession()
    y1 = s.process(x[:1024])
    s.checkpoint(str(tmp_path / "geq.npz"))
    y2 = s.process(x[1024:])
    np.testing.assert_array_equal(np.concatenate([y1, y2]), og.run(x))
    s2 = GEQSession()
    s2.restore(str(tmp_path / "geq.npz"))
    np.testing.assert_array_equal(s2.process(x[1024:]), y2)


def test_aec_session_checkpoint(rng, tmp_path):
    from jeicyboodsp_tpu.io.stream import AECSession
    from jeicyboodsp_tpu.oracle import nlms as onl

    n = 1024 * 3
    x = np.clip(rng.normal(0, 3000, n), -32768, 32767).astype(np.int16)
    h = rng.normal(0, 0.1, 16)
    h[0] = 0.5
    ref = np.clip(np.convolve(x.astype(np.float64), h)[:n], -32768, 32767).astype(np.int16)
    s = AECSession("nlms")
    e1, r1 = s.process(x[:1024], ref[:1024])
    s.checkpoint(str(tmp_path / "aec.npz"))
    e2, r2 = s.process(x[1024:], ref[1024:])
    oe, oerr = onl.run_nlms(x, ref)  # oracle drops block 1
    np.testing.assert_array_equal(np.concatenate([e1, e2])[1024:], oe)
    s2 = AECSession("nlms")
    s2.restore(str(tmp_path / "aec.npz"))
    e2b, _ = s2.process(x[1024:], ref[1024:])
    np.testing.assert_array_equal(e2, e2b)

"""Per-(pipeline, engine) fidelity matrix.

Every engine reachable from the CLI (`--engine {xla,mxu,mxu3,gemm,gemm8,
gemm8hq}`) runs a small probe and is asserted against its documented SNR
floor vs the f64 oracle (config.ENGINE_FIDELITY), so `--engine` cannot
silently ship a sub-bar configuration.  These run on the CPU backend, which
computes float32 dots in float32; chip_smoke.py asserts the same floors on
the GPU, where each engine's dot algorithm (ops/dft.py) is what the card
runs.  Engine names that no pipeline implements are refused, never aliased.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from jeicyboodsp_tpu.utils.metrics import snr_db


@pytest.fixture(scope="module")
def probe():
    rng = np.random.default_rng(11)
    t = np.arange(64 * 512) / 16000.0
    sp = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    return np.clip(sp + rng.normal(0, 20, 64 * 512), -32768, 32767).astype(np.int16)


@pytest.mark.parametrize(
    "mode,engine,floor",
    [
        ("wiener", "xla", 95.0),
        ("wiener", "mxu", 90.0),
        ("wiener", "mxu3", 90.0),
        ("specsub", "xla", 95.0),
        ("specsub", "mxu3", 90.0),
    ],
)
def test_enhance_engine_floor(probe, mode, engine, floor):
    from jeicyboodsp_tpu.oracle import enhance as oenh
    from jeicyboodsp_tpu.ops import enhance as E

    want = oenh.run(probe, mode)
    got = E.run_stream(probe, mode, dtype=jnp.float32, use_assoc_scan=True, fft_engine=engine)
    assert snr_db(want, got) >= floor


@pytest.mark.parametrize("engine,floor", [("xla", 80.0), ("mxu", 80.0), ("mxu3", 80.0)])
def test_mvdr_engine_floor(probe, engine, floor):
    from jeicyboodsp_tpu.oracle import mvdr as omv
    from jeicyboodsp_tpu.ops import mvdr as M

    rng = np.random.default_rng(12)
    xr = np.clip(
        0.8 * probe.astype(np.float64) + rng.normal(0, 15, len(probe)), -32768, 32767
    ).astype(np.int16)
    want = omv.run(probe, xr)
    got = M.run_stream(probe, xr, 0.0, dtype=jnp.float32, fft_engine=engine)
    assert snr_db(want, got) >= floor


@pytest.mark.parametrize("engine,floor", [("xla", 100.0), ("mxu", 100.0)])
def test_mfcc_engine_floor(probe, engine, floor):
    from jeicyboodsp_tpu.oracle import mfcc as omf
    from jeicyboodsp_tpu.ops import features as FE

    want = omf.run(probe)
    got = np.asarray(FE.mfcc_run(probe, dtype=jnp.float32, fft_engine=engine))
    assert snr_db(want, got) >= floor


@pytest.mark.parametrize(
    "engine,floor",
    [("auto", 85.0), ("xla", 88.0), ("gemm", 95.0),
     # 2-term int8 Toeplitz GEMM: operator-split residual bounds it
     # (~76.6-84.9 dB measured; the 3-dot form without l@Ml was 54.6)
     ("gemm8", 70.0),
     # 3-term form (r5, the --fast default): 5th dot recaptures the
     # operator residual -- +21 dB over gemm8 per the numpy decomposition;
     # 86.3 dB on this probe (the residual-free floor: output int16
     # truncation flips on the low-level segments)
     ("gemm8hq", 85.0)],
)
def test_fastconv_engine_floor(probe, engine, floor):
    from jeicyboodsp_tpu.oracle import fastconv as ofc
    from jeicyboodsp_tpu.ops import fastconv as FC

    want = ofc.run(probe)
    got = FC.run_stream(probe, dtype=jnp.float32, real_fft=True, fft_engine=engine)
    assert snr_db(want, got) >= floor


def test_fastconv_sparse_floor(probe):
    from jeicyboodsp_tpu.oracle import fastconv as ofc
    from jeicyboodsp_tpu.ops.fastconv import fastconv_blocks_sparse

    want = ofc.run(probe)
    got = np.asarray(
        fastconv_blocks_sparse(jnp.asarray(probe.reshape(-1, 1024)), dtype=jnp.float32)
    ).reshape(-1)
    assert snr_db(want, got) >= 95.0


@pytest.mark.parametrize("engine,floor", [("xla", 68.0), ("radix2", 65.0)])
def test_fft_engine_floor(probe, engine, floor):
    from jeicyboodsp_tpu.oracle import fftprog
    from jeicyboodsp_tpu.ops import fft as F

    want = fftprog.run(probe[: 16 * 512])
    got = np.asarray(
        F.roundtrip_blocks(jnp.asarray(probe[: 16 * 512].reshape(-1, 512)),
                           dtype=jnp.float32, engine=engine)
    ).reshape(-1)
    assert snr_db(want, got) >= floor


@pytest.mark.parametrize(
    "pipeline,engine",
    [("enhance", "mxu8"), ("enhance", "mxu8f"), ("enhance", "mxu8t"),
     ("enhance", "mxu1"), ("fastconv", "mxu"), ("fastconv", "mxu3"),
     ("mfcc", "mxu8"), ("mfcc", "mxu3"), ("pitch", "mxu8")],
)
def test_removed_engine_names_are_refused(probe, pipeline, engine):
    from jeicyboodsp_tpu.ops import enhance as E
    from jeicyboodsp_tpu.ops import fastconv as FC
    from jeicyboodsp_tpu.ops import features as FE

    run = {
        "enhance": lambda: E.run_stream(probe, "wiener", dtype=jnp.float32, fft_engine=engine),
        "fastconv": lambda: FC.run_stream(probe, dtype=jnp.float32, fft_engine=engine),
        "mfcc": lambda: FE.mfcc_run(probe, dtype=jnp.float32, fft_engine=engine),
        "pitch": lambda: FE.pitch_run(probe, 2, dtype=jnp.float32, fft_engine=engine),
    }[pipeline]
    with pytest.raises(ValueError, match="unknown"):
        run()

"""Empty-payload behavior: the reference binaries exit cleanly and emit
nothing on a header-only input file (verified against bench/ref_cpp); the
framework's host run functions must do the same, not crash (the guards
live host-side, before anything is traced)."""

import numpy as np


def test_geq_empty():
    from jeicyboodsp_tpu.ops import geq

    assert len(geq.stream_blocks(np.zeros(0, np.int16))) == 0
    assert len(geq.stream_blocks(np.zeros(0, np.int16), dtype=np.float32)) == 0


def test_enhance_empty():
    from jeicyboodsp_tpu.ops import enhance

    assert len(enhance.run_stream(np.zeros(0, np.int16), "wiener")) == 0


def test_fastconv_empty():
    from jeicyboodsp_tpu.ops import fastconv

    assert len(fastconv.run_stream(np.zeros(0, np.int16))) == 0


def test_mvdr_empty():
    from jeicyboodsp_tpu.ops import mvdr

    assert len(mvdr.run_stream(np.zeros(0, np.int16), np.zeros(0, np.int16))) == 0


def test_pitch_empty():
    from jeicyboodsp_tpu.ops import features

    arg, val, f0 = features.pitch_run(np.zeros(0, np.int16), 1)
    assert len(arg) == 0 and len(val) == 0 and len(f0) == 0


def test_nlms_empty():
    from jeicyboodsp_tpu.ops import nlms

    est, err = nlms.run_nlms_stream(np.zeros(0, np.int16), np.zeros(0, np.int16))
    assert len(est) == 0 and len(err) == 0

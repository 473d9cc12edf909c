"""On-card checks: every chip_smoke phase on the GPU at a short size.

Runs only on a GPU host, in its own lane:

    JEICYBOO_GPU_TESTS=1 python -m pytest tests/test_gpu.py -m gpu

Elsewhere each test skips (decided in the fixture, never at import).
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SHORT = dict(cs.FULL)
SHORT.update(
    enhance_blocks=2048, stream_blocks=256, geq_seconds=1, fastconv_blocks=256,
    nlms_seconds=2, bnlms_seconds=10, mvdr_seconds=10, fft_seconds=10, pitch_seconds=10,
    mfcc_seconds=10, awgn_seconds=10, gmm_classes=5, gmm_frames=256, gmm_test_files=2,
    viterbi_frames=1024, oracle_blocks=2048, oracle_nlms_blocks=4, oracle_short_blocks=64,
    gmm_oracle_classes=2,
)


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run with JEICYBOO_GPU_TESTS=1 on a GPU host")
    return jax.devices()[0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", [n for n, _ in cs.one_card_phases()])
def test_phase_on_gpu(gpu, name):
    phase = dict(cs.one_card_phases())[name]
    rec = cs.run_phases([(name, phase)], SHORT, emit=lambda _: None)[0]
    assert rec["ok"], rec

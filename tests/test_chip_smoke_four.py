"""chip_smoke.py --four rehearsed on four virtual CPU devices: each
sharded path agrees with its one-device op within the stated limit."""

import os
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TINY = dict(cs.FULL)
TINY.update(
    four_enhance_blocks=64, four_fastconv_blocks=24, four_mvdr_blocks=32, four_geq_blocks=16,
    four_sessions=8, four_session_blocks=2, four_time_blocks=8, four_speech_blocks=16,
)

NAMES = [
    "four_enhance_sharded", "four_enhance_sharded2d", "four_fastconv_sharded",
    "four_mvdr_sharded_bins", "four_geq_sharded", "four_bnlms_sessions",
    "four_nlms_sessions", "four_bnlms_sharded_time", "four_speech_sharded",
]


def test_four_phase_names():
    assert [n for n, _ in cs.four_phases(4)] == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_four_phase_agrees_on_virtual_devices(name):
    assert len(jax.devices()) >= 4
    phase = dict(cs.four_phases(4))[name]
    rec = cs.run_phases([(name, phase)], TINY, emit=lambda _: None)[0]
    assert rec["ok"], rec
    assert "one_device_steady_s" in rec, rec

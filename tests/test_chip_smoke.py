"""chip_smoke.py rehearsed on the CPU: every phase at a tiny size (the
script's main refuses a non-GPU backend), the refusal itself, and the
shape of the success line."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TINY = dict(cs.FULL)
TINY.update(
    enhance_blocks=48, stream_blocks=40, stream_chunk=8, geq_seconds=1, fastconv_blocks=24,
    nlms_seconds=1, bnlms_seconds=2, mvdr_seconds=2, fft_seconds=1, pitch_seconds=2,
    mfcc_seconds=2, awgn_seconds=2, gmm_classes=3, gmm_frames=64, gmm_test_files=2,
    viterbi_frames=64, oracle_blocks=48, oracle_geq_blocks=8, oracle_nlms_blocks=3,
    oracle_short_blocks=16, gmm_oracle_classes=2,
)

ONE_CARD = dict(cs.one_card_phases())


def test_phase_list_covers_every_cli_pipeline():
    from jeicyboodsp_tpu.pipelines import PIPELINES

    names = {n.replace("_", "-") for n in ONE_CARD}
    missing = [p for p in PIPELINES
               if p not in names and not any(n.startswith(p + "-") for n in names)]
    assert not missing, missing


@pytest.mark.parametrize("name", sorted(ONE_CARD))
def test_phase_meets_its_limit_on_cpu(name, tmp_path):
    rec = cs.run_phases([(name, ONE_CARD[name])], TINY, emit=lambda _: None)[0]
    assert rec["ok"], rec
    for key in ("samples", "setup_s", "steady_s", "samples_per_s", "metric", "value",
                "limit", "precision"):
        assert key in rec, (key, rec)


def test_failing_phase_is_recorded_not_raised():
    def boom(ctx):
        raise ValueError("no")

    rec = cs.run_phases([("boom", boom)], TINY, emit=lambda _: None)[0]
    assert rec == {"phase": "boom", "ok": False, "error": "ValueError: no"}


def test_main_refuses_cpu_backend(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_main_last_line_shape(monkeypatch, capsys):
    """With a GPU backend reported, main prints the card lines, one line
    per phase, and as its last line exactly the ok/device object."""
    import jax

    from jeicyboodsp_tpu.utils import runtime

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(runtime, "card_info", lambda: ["NVIDIA H100 80GB HBM3, 700.00 W"])
    monkeypatch.setattr(cs, "one_card_phases", lambda: [("wiener_mxu3", ONE_CARD["wiener_mxu3"])])
    monkeypatch.setattr(cs, "FULL", TINY)
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "card: NVIDIA H100 80GB HBM3, 700.00 W"
    last = json.loads(lines[-1])
    assert set(last) == {"ok", "device"} and last["ok"] is True
    assert set(last["device"]) == {"platform", "kind", "count"}
    assert last["device"]["count"] == len(jax.devices())
    assert any(line.startswith("phase ") for line in lines[:-1])


def test_main_fails_when_a_phase_misses(monkeypatch, capsys):
    import jax

    from jeicyboodsp_tpu.utils import runtime

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(runtime, "card_info", lambda: ["card"])
    monkeypatch.setattr(cs, "one_card_phases", lambda: [("miss", lambda c: {"phase": "miss", "ok": False})])
    assert cs.main([]) == 1
    assert '"ok": true' not in capsys.readouterr().out

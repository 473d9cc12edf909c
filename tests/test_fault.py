"""Pipeline-level fault harness: kill-and-resume == uninterrupted (SURVEY §5
failure detection / elastic recovery).

Extends the session-level checkpoint test (test_streaming.py) to the CLI
surface: a `stream` run is hard-killed mid-stream (os._exit fault injector,
a SIGKILL stand-in that skips every flush/atexit), restarted from its
checkpoint -- twice -- and the final output must be BYTE-IDENTICAL to a
never-interrupted run.
"""

import os
import subprocess
import sys

import numpy as np

from jeicyboodsp_tpu.io.wav import read_pcm16, write_pcm16

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args, timeout=280):
    # the child stays on the CPU backend: one JAX process per card
    return subprocess.run(
        [sys.executable, "-m", "jeicyboodsp_tpu.cli", *args, "--cpu"],
        cwd=ROOT,
        capture_output=True,
        timeout=timeout,
    )


def test_kill_and_resume_byte_identical(rng, tmp_path):
    n = 512 * 64
    t = np.arange(n) / 16000
    speech = 5000 * np.sin(2 * np.pi * 313 * t) * (t > 0.4)
    x = np.clip(speech + rng.normal(0, 20, n), -32768, 32767).astype(np.int16)
    inp = str(tmp_path / "in.pcm")
    write_pcm16(inp, x)

    # uninterrupted run
    out_a = str(tmp_path / "a.pcm")
    r = _cli("stream", inp, out_a, "wiener")
    assert r.returncode == 0, r.stderr.decode()[-1500:]

    # interrupted run: killed after 3 chunks, then after 3 more, then allowed
    # to finish -- each restart resumes from the last atomic checkpoint
    out_b = str(tmp_path / "b.pcm")
    ck = str(tmp_path / "ck.npz")
    common = ("stream", inp, out_b, "wiener", "--ckpt", ck, "--ckpt-every", "2")
    r1 = _cli(*common, "--crash-after", "3")
    assert r1.returncode == 137, (r1.returncode, r1.stderr.decode()[-800:])
    assert os.path.exists(ck)  # at least one checkpoint committed
    r2 = _cli(*common, "--crash-after", "3")
    assert r2.returncode == 137
    r3 = _cli(*common)
    assert r3.returncode == 0, r3.stderr.decode()[-1500:]

    a = read_pcm16(out_a)
    b = read_pcm16(out_b)
    np.testing.assert_array_equal(a, b)
    assert len(a) > 0

    # the streaming surface equals the batch pipeline output (same samples)
    from jeicyboodsp_tpu.io.stream import EnhanceSession

    sess = EnhanceSession("wiener")
    want = sess.process(x.reshape(-1, 512))
    np.testing.assert_array_equal(a, want)


def test_stream_edge_cases(tmp_path):
    """Empty and sub-chunk inputs through the stream pipeline."""
    from jeicyboodsp_tpu.pipelines.registry import stream_enhance

    empty = str(tmp_path / "empty.pcm")
    open(empty, "wb").close()
    out = str(tmp_path / "out.pcm")
    stream_enhance(empty, out, "wiener")
    assert os.path.getsize(out) == 0

    short = str(tmp_path / "short.pcm")
    write_pcm16(short, np.zeros(300, np.int16))  # < one block
    stream_enhance(short, out, "wiener")
    assert os.path.getsize(out) == 0  # no full block -> no output


def test_stream_resume_with_deleted_output(rng, tmp_path):
    """A checkpoint whose output file was deleted restarts from scratch and
    still produces byte-identical output (no zero-filled prefix)."""
    from jeicyboodsp_tpu.pipelines.registry import stream_enhance

    n = 512 * 24
    t = np.arange(n) / 16000
    x = np.clip(
        5000 * np.sin(2 * np.pi * 313 * t) * (t > 0.3) + rng.normal(0, 20, n),
        -32768, 32767,
    ).astype(np.int16)
    inp = str(tmp_path / "in.pcm")
    write_pcm16(inp, x)
    ref_out = str(tmp_path / "ref.pcm")
    stream_enhance(inp, ref_out, "wiener")

    out = str(tmp_path / "o.pcm")
    ck = str(tmp_path / "ck.npz")
    # the fault injector os._exit()s -- must run in a subprocess
    r = _cli("stream", inp, out, "wiener", "--ckpt", ck, "--ckpt-every", "2",
             "--crash-after", "3")
    assert r.returncode == 137
    assert os.path.exists(ck)
    os.remove(out)  # user deletes the partial output; checkpoint is stale
    stream_enhance(inp, out, "wiener", ckpt=ck)
    np.testing.assert_array_equal(read_pcm16(out), read_pcm16(ref_out))

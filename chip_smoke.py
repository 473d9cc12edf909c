#!/usr/bin/env python3
"""Smoke test on the GPU: every CLI pipeline, in both modes, at sizes users run.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four        # four GPUs: only the sharded paths,
                                       # each against its one-device op
    python chip_smoke.py --out F.json  # also write every phase record to F

Each phase drives the user's entry point (``jeicyboodsp_tpu.cli.main``
with files in a temporary directory, or the jitted op for the engine
timings), runs it twice, and prints one ``phase {...}`` line: set-up
seconds (the first call minus the steady one: compilation and first-touch;
slightly negative where nothing compiles), steady seconds, samples/s, the
process's peak device bytes so far, and the check against the f64 oracle
(SNR or mismatch count) beside the limit it must meet and the dot
algorithm the engine asks for.  Every pipeline runs once with ``--fast``
and once in compat mode (``compat_*`` phases, float64).

The last line is ``{"ok": true, "device": {...}}``.  The script exits
non-zero and prints no ``ok`` line when the default backend is not ``gpu``,
when any phase raises, or when any phase misses its limit.  Everything runs
in this one process: a second JAX process on the card would fail for want
of memory.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

FS = 16000

# Sizes a user would call real.  The enhance chain runs the 16,384-block
# (8.39 M samples, ~8.7 min of 16 kHz audio) stream; the per-sample
# recursions (geq --fast, nlms --fast) are device loops with one step per
# sample, so they get seconds of audio.  ``oracle_*`` is the prefix the
# f64 oracle checks: every pipeline is causal, so the first samples of the
# full run must equal the oracle's output on the input's prefix.
FULL = dict(
    enhance_blocks=16384, stream_blocks=4096, stream_chunk=16,
    geq_seconds=10, fastconv_blocks=2048, nlms_seconds=10, bnlms_seconds=60,
    mvdr_seconds=60, fft_seconds=60, pitch_seconds=60, mfcc_seconds=60,
    awgn_seconds=60, gmm_classes=25, gmm_frames=512, gmm_test_files=4,
    viterbi_frames=4096, oracle_blocks=16384, oracle_geq_blocks=40,
    oracle_nlms_blocks=16, oracle_short_blocks=128, gmm_oracle_classes=4,
    four_enhance_blocks=16384, four_fastconv_blocks=2048, four_mvdr_blocks=2048,
    four_geq_blocks=512, four_sessions=64, four_session_blocks=16,
    four_time_blocks=64, four_speech_blocks=64,
)

def speech_signal(n: int, seed: int, fs: int = FS) -> np.ndarray:
    """Gated 313 Hz tone + noise: speech/noise segments for the VAD."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    sp = 5000 * np.sin(2 * np.pi * 313 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0.2)
    return np.clip(sp + rng.normal(0, 20, n), -32768, 32767).astype(np.int16)


def contract(pipeline: str, engine: str):
    """(floor, dot algorithm) of an engine (config.ENGINE_FIDELITY)."""
    from jeicyboodsp_tpu.config import ENGINE_FIDELITY

    row = ENGINE_FIDELITY[(pipeline, engine)]
    return row["floor"], row["algo"]


def snr_db(ref, test) -> float:
    from jeicyboodsp_tpu.utils.metrics import snr_db as _snr

    return float(min(_snr(np.asarray(ref), np.asarray(test)), 999.0))


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_cli(args: list[str]) -> str:
    """One CLI call in this process; returns what it printed."""
    from jeicyboodsp_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    if rc != 0:
        raise RuntimeError(f"cli {args[0]} exited {rc}: {buf.getvalue()[-500:]}")
    return buf.getvalue()


def twice(fn, reset=None):
    """Run ``fn`` twice (``reset`` before each); returns (first, steady, out)."""
    import jax

    times, out = [], None
    for _ in range(2):
        if reset:
            reset()
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return times[0], times[1], out


def record(name, samples, first, steady, metric, value, limit, precision, ok, **extra):
    rec = dict(
        phase=name, samples=int(samples), setup_s=round(first - steady, 4),
        steady_s=round(steady, 6), samples_per_s=round(samples / steady, 1),
        peak_bytes=peak_bytes(), metric=metric, value=value, limit=limit,
        precision=precision, ok=bool(ok),
    )
    rec.update(extra)
    return rec


# --------------------------------------------------------------------------
# one-card phases
# --------------------------------------------------------------------------
#
# Each CLI phase runs in one of the CLI's two modes: ``--fast`` (float32,
# checked at the engine's floor) or compat (no flag: float64, checked at
# the exactness the repo documents for that pipeline, COVERAGE.md).  The
# CLI turns on x64 for the rest of the process in compat mode, so every
# compat phase runs after every fast one.


def _flags(compat: bool, engine: str | None = None) -> list[str]:
    if compat:
        return []
    return ["--fast"] + (["--engine", engine] if engine else [])


def _name(base: str, compat: bool) -> str:
    return f"compat_{base}" if compat else base


def _lsb(want, got, frac=0.01):
    """(mismatch count, ok): equal up to +-1 int16 LSB on <= frac of samples
    (another FFT library, or float sums regrouped across shards, expose
    ulps through the int16 truncation)."""
    d = np.abs(np.asarray(want).astype(np.int64) - np.asarray(got).astype(np.int64))
    return int((d != 0).sum()), bool(d.size and d.max() <= 1 and (d != 0).mean() <= frac)


def _over_tol(want, got, rtol, atol):
    """max |got - want| / (atol + rtol |want|): <= 1 is within tolerance."""
    w, g = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float((np.abs(g - w) / (atol + rtol * np.abs(w))).max())


def phase_enhance_cli(ctx, mode: str, engine: str | None = None, compat: bool = False):
    """``<mode> IN OUT [--fast --engine E]`` on the 16,384-block stream:
    SNR at the engine's floor, or byte for byte in compat."""
    from jeicyboodsp_tpu.io.wav import read_pcm16, write_pcm16
    from jeicyboodsp_tpu.oracle import enhance as oenh

    T = ctx["enhance_blocks"]
    x = speech_signal(T * 512, seed=1)
    inp = ctx.path(f"{mode}_in.pcm")
    out = ctx.path(f"{mode}_{engine or 'compat'}.pcm")
    write_pcm16(inp, x)
    first, steady, _ = twice(lambda: run_cli([mode, inp, out] + _flags(compat, engine)))
    got = read_pcm16(out)
    want = ctx.oracle(("enhance", mode), lambda: oenh.run(x[: ctx["oracle_blocks"] * 512], mode))
    n_ok = len(got) == (T - 2) * 512
    if compat:
        miss = int((got[: len(want)] != want).sum())
        return record(f"compat_{mode}", len(x), first, steady, "mismatched_samples", miss,
                      "== 0 (byte-identical)", "float64 jnp.fft", n_ok and miss == 0,
                      compared=len(want))
    floor, algo = contract("enhance", engine)
    val = snr_db(want, got[: len(want)])
    return record(f"{mode}_{engine}", len(x), first, steady, "snr_db", round(val, 2),
                  f">= {floor}", algo, n_ok and val >= floor)


ENHANCE_OPS = {
    # name: enhance_blocks keyword arguments (wiener); "xla" is the CLI's
    # complex-FFT form, "xla_rfft" the real-FFT form of the same engine
    "xla": dict(real_fft=False, resynth="trig", fft_engine="xla"),
    "xla_rfft": dict(real_fft=True, resynth="ratio", fft_engine="xla"),
    "mxu": dict(real_fft=True, resynth="ratio", fft_engine="mxu"),
    "mxu3": dict(real_fft=True, resynth="ratio", fft_engine="mxu3"),
}


def phase_enhance_op(ctx, variant: str):
    """Device time of the jitted chain alone (no file I/O), block_until_ready."""
    import jax
    import jax.numpy as jnp

    from jeicyboodsp_tpu.oracle import enhance as oenh
    from jeicyboodsp_tpu.ops.enhance import enhance_blocks

    T = ctx["enhance_blocks"]
    x = speech_signal(T * 512, seed=1)
    blocks = jax.device_put(jnp.asarray(x.reshape(T, 512)))
    kw = dict(mode="wiener", dtype=jnp.float32, use_assoc_scan=True, **ENHANCE_OPS[variant])
    first, _, (out, mask) = twice(lambda: enhance_blocks(blocks, **kw))
    steady = min(twice(lambda: enhance_blocks(blocks, **kw))[:2])
    got = np.asarray(out)[np.asarray(mask)].reshape(-1)
    want = ctx.oracle(("enhance", "wiener"), lambda: oenh.run(x[: ctx["oracle_blocks"] * 512], "wiener"))
    floor, algo = contract("enhance", ENHANCE_OPS[variant]["fft_engine"])
    val = snr_db(want, got[: len(want)])
    return record(f"enhance_op_{variant}", len(x), first, steady, "snr_db", round(val, 2),
                  f">= {floor}", algo, val >= floor)


def phase_stream(ctx, compat: bool = False):
    """``stream IN OUT [--fast]`` with checkpoints: the chunked EnhanceSession."""
    from jeicyboodsp_tpu.io.wav import read_pcm16, write_pcm16
    from jeicyboodsp_tpu.oracle import enhance as oenh

    T = ctx["stream_blocks"]
    x = speech_signal(T * 512, seed=1)
    inp, out, ck = ctx.path("stream_in.pcm"), ctx.path("stream_out.pcm"), ctx.path("stream.npz")
    write_pcm16(inp, x)

    def reset():
        for p in (out, ck):
            if os.path.exists(p):
                os.remove(p)

    args = ["stream", inp, out, "--ckpt", ck, "--ckpt-every", "4",
            "--chunk-blocks", str(ctx["stream_chunk"])] + _flags(compat)
    first, steady, _ = twice(lambda: run_cli(args), reset=reset)
    got = read_pcm16(out)
    want = ctx.oracle(("enhance", "wiener"), lambda: oenh.run(x[: ctx["oracle_blocks"] * 512], "wiener"))
    n = min(len(want), len(got))
    n_ok = os.path.exists(ck) and len(got) == (T - 2) * 512
    if compat:
        miss = int((got[:n] != want[:n]).sum())
        return record("compat_stream", len(x), first, steady, "mismatched_samples", miss,
                      "== 0 (byte-identical)", "float64 jnp.fft", n_ok and miss == 0,
                      compared=n, chunk_blocks=ctx["stream_chunk"])
    floor, algo = contract("enhance", "xla")
    val = snr_db(want[:n], got[:n])
    return record("stream", len(x), first, steady, "snr_db", round(val, 2), f">= {floor}",
                  algo, n_ok and val >= floor, chunk_blocks=ctx["stream_chunk"])


def phase_geq(ctx, compat: bool = False):
    """``geq IN OUT [--fast]``.  --fast: the per-sample int16-feedback
    cascade as a float64 device loop (lax.scan), at the floor of
    tests/test_geq.py::test_jax_scan_close (XLA may contract mul+add into
    fma and flip a truncation).  Compat: the native host kernel, byte for
    byte."""
    from jeicyboodsp_tpu import native
    from jeicyboodsp_tpu.io.wav import read_pcm16, write_wav
    from jeicyboodsp_tpu.oracle import geq as ogeq

    n = ctx["geq_seconds"] * 48000 // 512 * 512
    x = speech_signal(n, seed=2, fs=48000)
    inp, out = ctx.path("geq_in.wav"), ctx.path("geq_out.pcm")
    write_wav(inp, x, 48000)
    first, steady, _ = twice(lambda: run_cli(["geq", inp, out] + _flags(compat)))
    got = read_pcm16(out)
    m = ctx["oracle_geq_blocks"] * 512
    want = ctx.oracle(("geq", m), lambda: ogeq.run(x[:m]))
    miss = int((got[:m] != want).sum())
    if compat:
        where = "native host kernel" if native.available() else "device scan"
        return record("compat_geq", n, first, steady, "mismatched_samples", miss,
                      "== 0 (byte-identical)", f"float64 {where}", len(got) == n and miss == 0,
                      compared=m)
    val = snr_db(want, got[:m])
    return record("geq", n, first, steady, "snr_db", round(val, 2), ">= 45.0",
                  "float64 scalar recursion", len(got) == n and val >= 45.0,
                  mismatched_samples=miss, compared=m)


def phase_fastconv(ctx, engine: str = "gemm8hq", compat: bool = False):
    """``fastconv IN OUT [--fast --engine E]``.  --fast (default gemm8hq:
    int8 x int8 -> int32 dots) at its ENGINE_FIDELITY floor, plus an
    exactness check of one int8 dot against numpy int64.  Compat: the
    float64 FFT path within +-1 LSB on <= 0.3% of samples (the f64 FFT
    libraries round differently; tests/test_fastconv.py)."""
    import jax
    import jax.numpy as jnp

    from jeicyboodsp_tpu.io.wav import read_pcm16, write_wav
    from jeicyboodsp_tpu.oracle import fastconv as ofc
    from jeicyboodsp_tpu.ops.fastconv import _toeplitz_int8

    T = ctx["fastconv_blocks"]
    x = speech_signal(T * 1024, seed=3)
    inp, out = ctx.path("fc_in.wav"), ctx.path("fc_out.pcm")
    write_wav(inp, x, FS)
    first, steady, _ = twice(lambda: run_cli(["fastconv", inp, out] + _flags(compat, engine)))
    got = read_pcm16(out)
    m = ctx["oracle_short_blocks"]
    want = ctx.oracle(("fastconv", m), lambda: ofc.run(x[: m * 1024]))
    n_ok = len(got) == (T - 7) * 1024
    if compat:
        miss, ok = _lsb(want, got[: len(want)], 3e-3)
        return record("compat_fastconv", len(x), first, steady, "lsb_mismatches", miss,
                      "max |diff| <= 1 on <= 0.3% of samples", "float64 jnp.fft", n_ok and ok,
                      compared=len(want))
    floor, algo = contract("fastconv", engine)
    val = snr_db(want, got[: len(want)])
    Mh = _toeplitz_int8()[0]
    a = np.random.default_rng(4).integers(-128, 128, (256, Mh.shape[0])).astype(np.int8)
    dev = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(Mh), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    exact = a.astype(np.int64) @ Mh.astype(np.int64)
    dot_diff = int((np.asarray(dev).astype(np.int64) != exact).sum())
    return record(f"fastconv_{engine}", len(x), first, steady, "snr_db", round(val, 2),
                  f">= {floor}; int8 dot mismatches == 0", algo,
                  n_ok and val >= floor and dot_diff == 0, int8_dot_mismatches=dot_diff)


def _aec_signals(n, seed):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(0, 3000, n), -32768, 32767).astype(np.int16)
    h = rng.normal(0, 0.1, 32)
    h[0] = 0.5
    ref = np.clip(np.convolve(x.astype(np.float64), h)[:n] + rng.normal(0, 50, n),
                  -32768, 32767).astype(np.int16)
    return x, ref


def phase_aec(ctx, variant: str, compat: bool = False):
    """``nlms|bnlms IN REF EST ERR [--fast]`` vs the f64 oracle: the echo
    estimate's SNR at the floor tests/test_nlms.py pins, or (compat, the
    native host kernel) both outputs byte for byte."""
    from jeicyboodsp_tpu import native
    from jeicyboodsp_tpu.io.wav import read_pcm16, write_pcm16, write_wav
    from jeicyboodsp_tpu.oracle import nlms as onl

    secs = ctx["nlms_seconds"] if variant == "nlms" else ctx["bnlms_seconds"]
    n = secs * FS // 1024 * 1024
    x, ref = _aec_signals(n, seed=5)
    inp, rp = ctx.path(f"{variant}_in.wav"), ctx.path(f"{variant}_ref.pcm")
    est, err = ctx.path(f"{variant}_est.pcm"), ctx.path(f"{variant}_err.pcm")
    write_wav(inp, x, FS)
    write_pcm16(rp, ref)
    first, steady, _ = twice(lambda: run_cli([variant, inp, rp, est, err] + _flags(compat)))
    got, got_err = read_pcm16(est), read_pcm16(err)
    m = ctx["oracle_nlms_blocks"] * 1024
    run = onl.run_nlms if variant == "nlms" else onl.run_bnlms
    want, want_err = ctx.oracle((variant, m), lambda: run(x[:m], ref[:m]))
    n_ok = len(got) == n - 1024
    if compat:
        miss = int((got[: len(want)] != want).sum() + (got_err[: len(want_err)] != want_err).sum())
        where = "native host kernel" if native.available() else "device scan"
        return record(f"compat_{variant}", n, first, steady, "mismatched_samples", miss,
                      "== 0 (byte-identical, estimate and error)", f"float64 {where}",
                      n_ok and miss == 0, compared=len(want) + len(want_err))
    val = snr_db(want, got[: len(want)])
    return record(variant, n, first, steady, "snr_db", round(val, 2), ">= 60.0",
                  "float32, Precision.HIGHEST dots", n_ok and val >= 60.0)


def phase_mvdr(ctx, engine: str = "xla", compat: bool = False):
    """``mvdr LEFT RIGHT OUT [--fast --engine E]`` vs the f64 oracle: 80 dB
    (ENGINE_FIDELITY's mvdr floor, for every engine), or (compat) +-1 LSB on
    <= 1% of samples (tests/test_mvdr.py)."""
    from jeicyboodsp_tpu.io.wav import read_pcm16, write_wav
    from jeicyboodsp_tpu.oracle import mvdr as omv

    n = ctx["mvdr_seconds"] * FS // 512 * 512
    xl = speech_signal(n, seed=6)
    rng = np.random.default_rng(6)
    xr = np.clip(0.8 * xl.astype(np.float64) + rng.normal(0, 15, n), -32768, 32767).astype(np.int16)
    lp, rp, out = ctx.path("mv_l.wav"), ctx.path("mv_r.wav"), ctx.path("mv_out.pcm")
    write_wav(lp, xl, FS)
    write_wav(rp, xr, FS)
    first, steady, _ = twice(lambda: run_cli(["mvdr", lp, rp, out] + _flags(compat, engine)))
    got = read_pcm16(out)
    m = ctx["oracle_short_blocks"] * 512
    want = ctx.oracle(("mvdr", m), lambda: omv.run(xl[:m], xr[:m]))
    if compat:
        miss, ok = _lsb(want, got[: len(want)], 0.01)
        return record("compat_mvdr", n, first, steady, "lsb_mismatches", miss,
                      "max |diff| <= 1 on <= 1% of samples", "float64 jnp.fft", ok,
                      compared=len(want))
    val = snr_db(want, got[: len(want)])
    floor, algo = contract("mvdr", engine)
    name = "mvdr" if engine == "xla" else f"mvdr_{engine}"
    return record(name, n, first, steady, "snr_db", round(val, 2), f">= {floor}",
                  algo, val >= floor)


def phase_fft(ctx, compat: bool = False):
    """``fft IN OUT [--fast]``: the reference-structured radix-2 roundtrip;
    compat within +-1 LSB everywhere and >= 70 dB (tests/test_fft_awgn.py)."""
    from jeicyboodsp_tpu.io.wav import read_pcm16, write_wav
    from jeicyboodsp_tpu.oracle import fftprog

    n = ctx["fft_seconds"] * FS // 512 * 512
    x = speech_signal(n, seed=7)
    inp, out = ctx.path("fft_in.wav"), ctx.path("fft_out.pcm")
    write_wav(inp, x, FS)
    first, steady, _ = twice(lambda: run_cli(["fft", inp, out] + _flags(compat)))
    got = read_pcm16(out)
    m = ctx["oracle_short_blocks"] * 512
    want = ctx.oracle(("fft", m), lambda: fftprog.run(x[:m]))
    val = snr_db(want, got[: len(want)])
    if compat:
        d = np.abs(want.astype(np.int64) - got[: len(want)].astype(np.int64))
        return record("compat_fft", n, first, steady, "max_abs_diff_lsb; snr_db",
                      [int(d.max()), round(val, 2)], "<= 1; >= 70.0",
                      "float64 radix-2 butterflies",
                      len(got) == n and d.max() <= 1 and val >= 70.0)
    return record("fft", n, first, steady, "snr_db", round(val, 2), ">= 65.0",
                  "float32 radix-2 butterflies", len(got) == n and val >= 65.0)


def phase_pitch(ctx, method: int, compat: bool = False):
    """``pitch<m> IN [--fast]``: per-block lags vs the oracle's (<= 5% may
    differ in float32); compat: every lag equal and every value within
    rtol 1e-9 (tests/test_features.py)."""
    from jeicyboodsp_tpu.io.wav import write_wav
    from jeicyboodsp_tpu.oracle import pitch as opitch

    n = ctx["pitch_seconds"] * FS // 512 * 512
    rng = np.random.default_rng(8)
    t = np.arange(n) / FS
    f0 = 120 + 60 * np.sin(2 * np.pi * 0.3 * t)
    x = np.clip(8000 * np.sin(2 * np.pi * np.cumsum(f0) / FS) + rng.normal(0, 300, n),
                -32768, 32767).astype(np.int16)
    inp = ctx.path("pitch_in.wav")
    write_wav(inp, x, FS)
    first, steady, text = twice(lambda: run_cli([f"pitch{method}", inp] + _flags(compat)))
    rows = [line.split() for line in text.splitlines() if line.startswith("Estimation arg")]
    lags = [int(r[2]) for r in rows]
    m = ctx["oracle_short_blocks"] * 512
    want = ctx.oracle(("pitch", method, m), lambda: opitch.run(x[:m], method))
    miss = sum(int(g != w) for g, (w, _, _) in zip(lags, want))
    n_ok = len(lags) == n // 512
    if compat:
        err = _over_tol([w[1] for w in want], [float(r[5]) for r in rows[: len(want)]], 1e-9, 0.0)
        return record(f"compat_pitch{method}", n, first, steady,
                      "lag_mismatches; value_err_over_tolerance", [miss, float(f"{err:.3g}")],
                      f"== 0 of {len(want)}; <= 1 (rtol 1e-9)", "float64 (jnp.fft / direct sums)",
                      n_ok and miss == 0 and err <= 1.0)
    limit = max(1, len(want) // 20)
    return record(f"pitch{method}", n, first, steady, "lag_mismatches", miss,
                  f"<= {limit} of {len(want)}", "float32 (jnp.fft / direct sums)",
                  n_ok and miss <= limit)


def phase_mfcc(ctx, engine: str = "xla", compat: bool = False):
    """``mfcc LIST [--fast --engine E]``: one file through the corpus path
    vs the oracle, at the engine's floor or (compat) within rtol = atol =
    1e-9 (tests/test_features.py)."""
    from jeicyboodsp_tpu.io.wav import write_wav
    from jeicyboodsp_tpu.oracle import mfcc as omf

    n = ctx["mfcc_seconds"] * FS // 1024 * 1024
    x = speech_signal(n, seed=9)
    wav, mfc, lst = ctx.path("mfcc_in.wav"), ctx.path("mfcc_out.mfc"), ctx.path("mfcc.lst")
    write_wav(wav, x, FS)
    with open(lst, "w") as f:
        f.write(f"{wav} {mfc}\n")
    first, steady, _ = twice(lambda: run_cli(["mfcc", lst] + _flags(compat, engine)))
    got = np.fromfile(mfc, dtype="<f8").reshape(-1, 12)
    m = ctx["oracle_short_blocks"] * 512
    want = ctx.oracle(("mfcc", m), lambda: omf.run(x[:m]))
    if compat:
        err = _over_tol(want, got[: len(want)], 1e-9, 1e-9)
        return record("compat_mfcc", n, first, steady, "max_err_over_tolerance",
                      float(f"{err:.3g}"), "<= 1 (rtol = atol = 1e-9)",
                      "float64 jnp.fft + Precision.HIGHEST mel/DCT", err <= 1.0)
    val = snr_db(want, got[: len(want)])
    floor, algo = contract("mfcc", engine)
    name = "mfcc" if engine == "xla" else f"mfcc_{engine}"
    return record(name, n, first, steady, "snr_db", round(val, 2), f">= {floor}",
                  algo + " + Precision.HIGHEST mel/DCT", val >= floor)


def _gmm_corpus(ctx):
    """Per-class feature files (separated sub-clusters so k-means stays
    populated), written once and shared by gmm-train and gmm-test."""
    if "gmm" in ctx.cache:
        return ctx.cache["gmm"]
    C, F = ctx["gmm_classes"], ctx["gmm_frames"]
    classes, lists = [], []
    for c in range(C):
        r = np.random.default_rng(1000 + c)
        center = r.normal(0, 10, 12)
        sub = center + r.normal(0, 4.0, (4, 12))
        frames = sub[(np.arange(F) // 4) % 4] + r.normal(0, 0.5, (F, 12))
        p = ctx.path(f"c{c}.mfc")
        frames.astype("<f8").tofile(p)
        lst = ctx.path(f"c{c}.lst")
        with open(lst, "w") as f:
            f.write(p)
        classes.append(frames)
        lists.append(lst)
    main = ctx.path("train.lst")
    with open(main, "w") as f:
        f.write("\n".join(lists))
    ctx.cache["gmm"] = (classes, main)
    return ctx.cache["gmm"]


def phase_gmm_train(ctx, compat: bool = False):
    """``gmm-train LIST MODEL [--fast]`` vs the oracle trainer (first
    classes): mixture weights and PCA eigenvalues (the exported covariance
    diagonal), both defined even where eigenvectors are not.  Compat holds
    them to tests/test_gmm.py's tolerances (rtol 1e-6 and 1e-4)."""
    from jeicyboodsp_tpu.models import serialization as S
    from jeicyboodsp_tpu.oracle import gmm as ogmm

    classes, main = _gmm_corpus(ctx)
    model = ctx.path("model_compat.bin" if compat else "model.bin")
    first, steady, _ = twice(lambda: run_cli(["gmm-train", main, model] + _flags(compat)))
    got = S.read_train_layout(model, len(classes))
    err_alpha = err_eig = 0.0
    for c in range(ctx["gmm_oracle_classes"]):
        want = ctx.oracle(("gmm_train", c), lambda c=c: ogmm.train_class([classes[c]]))
        ev_got = np.stack([np.diag(cv)[:8] for cv in got[c][2]])
        ev_want = np.stack([np.diag(cv)[:8] for cv in want.cov])
        err_alpha = max(err_alpha, float((np.abs(got[c][0] - want.alpha) / np.abs(want.alpha)).max()))
        err_eig = max(err_eig, float((np.abs(ev_got - ev_want) / np.abs(ev_want)).max()))
    frames = sum(len(f) for f in classes)
    if compat:
        return record("compat_gmm_train", frames, first, steady,
                      "max_rel_err_alpha; max_rel_err_pca_eigvals",
                      [float(f"{err_alpha:.3g}"), float(f"{err_eig:.3g}")], "<= 1e-6; <= 1e-4",
                      "float64, Precision.HIGHEST dots", err_alpha <= 1e-6 and err_eig <= 1e-4)
    worst = max(err_alpha, err_eig)
    return record("gmm_train", frames, first, steady, "max_rel_err_alpha_pca_eigvals",
                  float(f"{worst:.3g}"), "<= 1e-3", "float32, Precision.HIGHEST dots",
                  worst <= 1e-3)


def _reference_argmax(scores) -> int:
    """GMMAlgorithm_Test_Auto_ver2.cpp:117-124: strict <, first wins, and a
    NaN never displaces the incumbent (nor is displaced)."""
    arg, best = 0, scores[0]
    for u in range(1, len(scores)):
        if best < scores[u]:
            arg, best = u, scores[u]
    return arg


def _score_flushed(frames, alpha, mean, cov_diag4, eigvec4) -> float:
    """``oracle.gmm.score_file`` with every intermediate below float64's
    smallest normal flushed to zero, as XLA's CPU backend computes it: the
    witness for decisions that hinge on subnormal likelihoods."""
    from jeicyboodsp_tpu.oracle.gmm import REF_PI

    tiny = np.finfo(np.float64).tiny
    ftz = lambda v: np.where(np.abs(v) < tiny, 0.0 * v, v)
    s = np.zeros(len(frames))
    with np.errstate(all="ignore"):
        for k in range(4):
            e = ftz(np.exp(ftz(-0.5 * (frames @ eigvec4[k] - mean[k][:4]) ** 2 / cov_diag4[k])))
            t = ftz((1.0 / np.sqrt(2.0 * REF_PI)) * (1.0 / np.sqrt(cov_diag4[k])) * e)
            p = t[:, 0]
            for d in range(1, 4):
                p = ftz(p * t[:, d])
            s = ftz(s + ftz(alpha[k] * p))
        return float(np.mean(np.log(s)))


def _gmm_test_set(ctx):
    """Test files drawn from the training classes, their list files, and
    the oracle's decision for each: ``oracle.gmm.score_file`` on the
    parameters the reference's PCA4 classifier reads from the PCA8 model
    file (the chained layout the CLI uses), with the reference's argmax;
    and the same decisions with subnormals flushed (``_score_flushed``)."""
    if "gmm_test" in ctx.cache:
        return ctx.cache["gmm_test"]
    from jeicyboodsp_tpu.models import serialization as S
    from jeicyboodsp_tpu.oracle import gmm as ogmm

    classes, main = _gmm_corpus(ctx)
    model = ctx.path("model.bin")
    if not os.path.exists(model):
        run_cli(["gmm-train", main, model, "--fast"])
    r = np.random.default_rng(555)
    tlists, files = [], []
    for c, frames in enumerate(classes):
        paths = []
        for j in range(ctx["gmm_test_files"]):
            fr = frames[r.integers(0, len(frames), 128)] + r.normal(0, 0.3, (128, 12))
            p = ctx.path(f"t{c}_{j}.mfc")
            fr.astype("<f8").tofile(p)
            paths.append(p)
            files.append(fr)
        lst = ctx.path(f"t{c}.lst")
        with open(lst, "w") as f:
            f.write("\n".join(paths))
        tlists.append(lst)
    tmain = ctx.path("test.lst")
    with open(tmain, "w") as f:
        f.write("\n".join(tlists))
    params4 = [(a, mn, np.stack([np.diag(c)[:4] for c in cv]), ev)
               for a, mn, cv, ev in S.read_as_test_layout(model, len(classes))]
    want = [_reference_argmax([ogmm.score_file(fr, *p) for p in params4]) for fr in files]
    flushed = [_reference_argmax([_score_flushed(fr, *p) for p in params4]) for fr in files]
    ctx.cache["gmm_test"] = (tmain, model, want, flushed)
    return ctx.cache["gmm_test"]


def phase_gmm_test(ctx, compat: bool = False):
    """``gmm-test LIST MODEL [--fast]``: every printed decision against the
    oracle's (both modes score in float64: the reference's likelihoods are
    below float32's range on this layout, see pipelines/registry.gmm_test).
    Also reported: the decisions that differ from the flushed-subnormal
    witness, and how many files that witness decides differently."""
    tmain, model, want, flushed = _gmm_test_set(ctx)
    n_files = len(want)
    first, steady, text = twice(lambda: run_cli(["gmm-test", tmain, model] + _flags(compat)))
    got = [int(line.split()[-1]) - 1 for line in text.splitlines() if "-th result" in line]
    miss = sum(int(g != w) for g, w in zip(got, want))
    return record(_name("gmm_test", compat), n_files * 128, first, steady, "decision_mismatches",
                  miss, f"== 0 of {n_files}", "float64 scores, Precision.HIGHEST dots",
                  len(got) == n_files and miss == 0,
                  oracle_not_class_1=sum(int(w != 0) for w in want),
                  flushed_oracle_differs=sum(int(f != w) for f, w in zip(flushed, want)),
                  mismatches_vs_flushed=sum(int(g != f) for g, f in zip(got, flushed)))


def _viterbi_case(ctx):
    """A 6-state HMM file (small variances keep the log-of-log recursion
    finite) and an observation file of ``viterbi_frames`` frames."""
    if "viterbi" in ctx.cache:
        return ctx.cache["viterbi"]
    from jeicyboodsp_tpu.models import serialization as S

    rng = np.random.default_rng(19)
    F = ctx["viterbi_frames"]
    states = []
    for _ in range(6):
        a = np.full(4, 0.25)
        mn = np.zeros((4, 12))
        mn[:, :4] = rng.normal(0, 2, (4, 4))
        cv = np.stack([np.eye(12) * 0.01 for _ in range(4)])
        ev = np.stack([np.linalg.qr(rng.normal(0, 1, (12, 4)))[0] for _ in range(4)])
        states.append((a, mn, cv, ev))
    trans = rng.dirichlet(np.ones(6), size=6) + 0.5
    trans /= trans.sum(axis=1, keepdims=True)
    model = ctx.path("hmm.bin")
    with open(model, "wb") as f:
        f.write(S.pack_hmm(states, trans))
    seq = rng.integers(0, 6, F)
    obs = np.stack([states[s][3][0] @ states[s][1][0][:4] for s in seq]) + rng.normal(0, 0.02, (F, 12))
    mfc, lst = ctx.path("obs.mfc"), ctx.path("vit.lst")
    obs.astype("<f8").tofile(mfc)
    with open(lst, "w") as f:
        f.write(mfc)
    st4 = [(a, mn, np.stack([np.diag(c)[:4] for c in cv]), ev) for a, mn, cv, ev in states]
    ctx.cache["viterbi"] = (lst, model, obs, st4, trans)
    return ctx.cache["viterbi"]


def phase_viterbi(ctx, compat: bool = False):
    """``viterbi LIST MODEL [--fast]`` vs the oracle decode: --fast on a
    prefix (<= 1% of the path may differ); compat on the whole utterance,
    every state equal (tests/test_gmm.py)."""
    from jeicyboodsp_tpu.oracle import viterbi as ovit

    lst, model, obs, st4, trans = _viterbi_case(ctx)
    F = len(obs)
    first, steady, text = twice(lambda: run_cli(["viterbi", lst, model] + _flags(compat)))
    lines = text.splitlines()
    path = np.array([int(v) for v in lines[lines.index("decoding result !") + 1].split(",")])
    n_ok = len(path) == F - 1
    if compat:
        want, _ = ctx.oracle(("viterbi", F), lambda: ovit.hmm_decode(obs, st4, trans))
        miss = int((path != want).sum()) if n_ok else F
        return record("compat_viterbi", F, first, steady, "path_mismatches", miss,
                      f"== 0 of {F - 1}", "float64, Precision.HIGHEST dots", n_ok and miss == 0)
    m = min(F, ctx["oracle_short_blocks"] * 4)
    # the decode of a prefix differs only at its end (the reference's path
    # is read at t <= T-2), so compare the prefix run's interior
    want, _ = ctx.oracle(("viterbi", m), lambda: ovit.hmm_decode(obs[:m], st4, trans))
    miss = int((path[: m - 2] != want[: m - 2]).sum())
    limit = max(1, m // 100)
    return record("viterbi", F, first, steady, "path_mismatches", miss, f"<= {limit} of {m - 2}",
                  "float32, Precision.HIGHEST dots", n_ok and miss <= limit)


def phase_awgn(ctx, compat: bool = False):
    """``awgn IN OUT [--fast]``: sigma-10 int16-truncated noise per block
    (the reference is time-seeded, so the check is distributional)."""
    from jeicyboodsp_tpu.io.wav import read_pcm16, write_wav

    n = ctx["awgn_seconds"] * FS // 512 * 512
    x = speech_signal(n, seed=10)
    inp, out = ctx.path("awgn_in.wav"), ctx.path("awgn_out.pcm")
    write_wav(inp, x, FS)
    first, steady, _ = twice(lambda: run_cli(["awgn", inp, out] + _flags(compat)))
    noise = read_pcm16(out).astype(np.int64) - x.astype(np.int64)
    sd, mean = float(noise.std()), float(noise.mean())
    ok = len(noise) == n and abs(sd - 9.5) < 0.5 and abs(mean) < 0.1
    return record(_name("awgn", compat), n, first, steady, "noise_std", round(sd, 3),
                  "9.0 < std < 10.0 (N(0,10) truncated toward 0), |mean| < 0.1",
                  "float64 normal draws" if compat else "float32 normal draws", ok,
                  noise_mean=round(mean, 4))


def one_card_phases():
    phases = []
    for mode in ("wiener", "specsub"):
        for eng in ("xla", "mxu", "mxu3"):
            phases.append((f"{mode}_{eng}", lambda c, m=mode, e=eng: phase_enhance_cli(c, m, e)))
    for v in ENHANCE_OPS:
        phases.append((f"enhance_op_{v}", lambda c, v=v: phase_enhance_op(c, v)))
    phases += [
        ("stream", phase_stream),
        ("geq", phase_geq),
        ("fastconv_gemm8hq", phase_fastconv),
        ("fastconv_gemm8", lambda c: phase_fastconv(c, "gemm8")),
        ("fastconv_gemm", lambda c: phase_fastconv(c, "gemm")),
        ("fastconv_xla", lambda c: phase_fastconv(c, "xla")),
        ("nlms", lambda c: phase_aec(c, "nlms")),
        ("bnlms", lambda c: phase_aec(c, "bnlms")),
        ("mvdr", phase_mvdr),
        ("mvdr_mxu3", lambda c: phase_mvdr(c, "mxu3")),
        ("fft", phase_fft),
        ("pitch1", lambda c: phase_pitch(c, 1)),
        ("pitch2", lambda c: phase_pitch(c, 2)),
        ("pitch3", lambda c: phase_pitch(c, 3)),
        ("mfcc", phase_mfcc),
        ("mfcc_mxu", lambda c: phase_mfcc(c, "mxu")),
        ("gmm_train", phase_gmm_train),
        ("gmm_test", phase_gmm_test),
        ("viterbi", phase_viterbi),
        ("awgn", phase_awgn),
    ]
    # compat (float64) last: the CLI turns on x64 for the rest of the process
    phases += [
        ("compat_wiener", lambda c: phase_enhance_cli(c, "wiener", compat=True)),
        ("compat_specsub", lambda c: phase_enhance_cli(c, "specsub", compat=True)),
        ("compat_stream", lambda c: phase_stream(c, compat=True)),
        ("compat_geq", lambda c: phase_geq(c, compat=True)),
        ("compat_fastconv", lambda c: phase_fastconv(c, compat=True)),
        ("compat_nlms", lambda c: phase_aec(c, "nlms", compat=True)),
        ("compat_bnlms", lambda c: phase_aec(c, "bnlms", compat=True)),
        ("compat_mvdr", lambda c: phase_mvdr(c, compat=True)),
        ("compat_fft", lambda c: phase_fft(c, compat=True)),
        ("compat_pitch1", lambda c: phase_pitch(c, 1, compat=True)),
        ("compat_pitch2", lambda c: phase_pitch(c, 2, compat=True)),
        ("compat_pitch3", lambda c: phase_pitch(c, 3, compat=True)),
        ("compat_mfcc", lambda c: phase_mfcc(c, compat=True)),
        ("compat_gmm_train", lambda c: phase_gmm_train(c, compat=True)),
        ("compat_gmm_test", lambda c: phase_gmm_test(c, compat=True)),
        ("compat_viterbi", lambda c: phase_viterbi(c, compat=True)),
        ("compat_awgn", lambda c: phase_awgn(c, compat=True)),
    ]
    return phases


# --------------------------------------------------------------------------
# four-card phases: each sharded path against its one-device op
# --------------------------------------------------------------------------


def _timed_pair(single, sharded, *args):
    """Jit the one-device op and the sharded path over ``args`` and time
    both (steady = the second call)."""
    import jax

    single, sharded = jax.jit(single), jax.jit(sharded)
    s_first, s_steady, want = twice(lambda: single(*args))
    p_first, p_steady, got = twice(lambda: sharded(*args))
    extra = dict(one_device_steady_s=round(s_steady, 6),
                 one_device_setup_s=round(s_first - s_steady, 4))
    return want, got, extra, p_first, p_steady


def four_phases(n_dev: int):
    import jax
    import jax.numpy as jnp

    from jeicyboodsp_tpu.parallel import make_mesh
    from jeicyboodsp_tpu.parallel import sharded as S

    devices = jax.devices()[:n_dev]
    tmesh = make_mesh((n_dev,), ("time",), devices=devices)

    def enhance(ctx):
        from jeicyboodsp_tpu.ops.enhance import enhance_blocks

        T = ctx["four_enhance_blocks"]
        b = jnp.asarray(speech_signal(T * 512, seed=11).reshape(T, 512))
        want, got, ex, first, steady = _timed_pair(
            lambda b: enhance_blocks(b, mode="wiener", dtype=jnp.float32, use_assoc_scan=True),
            lambda b: S.enhance_sharded(b, tmesh, mode="wiener", dtype=jnp.float32), b)
        miss, ok = _lsb(want[0], got[0])
        ok = ok and bool((np.asarray(want[1]) == np.asarray(got[1])).all())
        return record("four_enhance_sharded", T * 512, first, steady, "lsb_mismatches", miss,
                      "max |diff| <= 1 on <= 1% of samples", "float32 jnp.fft", ok, **ex)

    def enhance2d(ctx):
        from jeicyboodsp_tpu.ops.enhance import enhance_blocks

        B, T = 2, ctx["four_enhance_blocks"] // 4
        xs = np.stack([speech_signal(T * 512, seed=12 + i).reshape(T, 512) for i in range(B)])
        b = jnp.asarray(xs)
        mesh = make_mesh((2, n_dev // 2), ("data", "time"), devices=devices)
        single = jax.vmap(lambda s: enhance_blocks(s, mode="wiener", dtype=jnp.float32,
                                                   use_assoc_scan=True)[0])
        want, got, ex, first, steady = _timed_pair(
            single, lambda b: S.enhance_sharded2d(b, mesh, dtype=jnp.float32)[0], b)
        miss, ok = _lsb(want, got)
        return record("four_enhance_sharded2d", B * T * 512, first, steady, "lsb_mismatches", miss,
                      "max |diff| <= 1 on <= 1% of samples", "float32 jnp.fft", ok, **ex)

    def fastconv(ctx):
        from jeicyboodsp_tpu.ops import fastconv as FC

        T = ctx["four_fastconv_blocks"]
        b = jnp.asarray(speech_signal(T * 1024, seed=13).reshape(T, 1024))
        Hr, Hi = FC.filter_spectrum(dtype=jnp.float32)
        want, got, ex, first, steady = _timed_pair(
            lambda b: FC.fastconv_blocks(b, Hr, Hi, dtype=jnp.float32),
            lambda b: S.fastconv_sharded(b, Hr, Hi, tmesh, dtype=jnp.float32), b)
        g = np.asarray(got[0])[np.asarray(got[1])]
        miss, ok = _lsb(want, g)
        return record("four_fastconv_sharded", T * 1024, first, steady, "lsb_mismatches", miss,
                      "max |diff| <= 1 on <= 1% of samples", "float32 jnp.fft", ok, **ex)

    def mvdr_bins(ctx):
        from jeicyboodsp_tpu.ops.mvdr import mvdr_blocks

        T = ctx["four_mvdr_blocks"]
        xl = speech_signal(T * 512, seed=14)
        rng = np.random.default_rng(14)
        xr = np.clip(0.8 * xl.astype(np.float64) + rng.normal(0, 15, len(xl)), -32768, 32767).astype(np.int16)
        bl, br = jnp.asarray(xl.reshape(T, 512)), jnp.asarray(xr.reshape(T, 512))
        mmesh = make_mesh((n_dev,), ("model",), devices=devices)
        want, got, ex, first, steady = _timed_pair(
            lambda bl, br: mvdr_blocks(bl, br, 0.0, dtype=jnp.float32, fft_engine="mxu",
                                       collapse=False),
            lambda bl, br: S.mvdr_sharded_bins(bl, br, mmesh, 0.0, axis="model"), bl, br)
        miss, ok = _lsb(want[0], got[0])
        return record("four_mvdr_sharded_bins", T * 512, first, steady, "lsb_mismatches", miss,
                      "max |diff| <= 1 on <= 1% of samples", "Precision.HIGHEST matmul DFT", ok, **ex)

    def geq(ctx):
        # float64: the float32 state-space scan loses ~20 dB at the 44 Hz
        # shelf's near-unity pole whichever way it is grouped
        from jeicyboodsp_tpu.ops.geq import geq_apply_fast, geq_coefficients

        n = ctx["four_geq_blocks"] * 512
        b, a = geq_coefficients()
        with jax.enable_x64(True):
            x = jnp.asarray(speech_signal(n, seed=15, fs=48000))
            want, got, ex, first, steady = _timed_pair(
                lambda x: geq_apply_fast(x, b, a, dtype=jnp.float64),
                lambda x: S.geq_sharded(x, b, a, tmesh, dtype=jnp.float64), x)
        w, g = np.asarray(want), np.asarray(got)
        err = float((np.abs(g - w) / (1e-5 + 1e-7 * np.abs(w))).max())
        return record("four_geq_sharded", n, first, steady, "max_err_over_tolerance",
                      float(f"{err:.3g}"), "<= 1 (|diff| <= 1e-5 + 1e-7 |ref|)",
                      "float64 associative scan", err <= 1.0, **ex)

    def sessions(ctx, variant):
        import functools

        from jeicyboodsp_tpu.ops import nlms as NL

        B, T = ctx["four_sessions"], ctx["four_session_blocks"]
        far = np.stack([_aec_signals(T * 1024, seed=100 + i)[0] for i in range(B)])
        near = np.stack([_aec_signals(T * 1024, seed=100 + i)[1] for i in range(B)])
        dmesh = make_mesh((n_dev,), ("data",), devices=devices)
        if variant == "bnlms":
            f, r = jnp.asarray(far.reshape(B, T, 1024)), jnp.asarray(near.reshape(B, T, 1024))
            init, apply, shard = NL.bnlms_init_state, NL.bnlms_apply, S.bnlms_sharded
            kw = {}
        else:
            f, r = jnp.asarray(far[:, :1024]), jnp.asarray(near[:, :1024])
            init, apply, shard = NL.nlms_init_state, NL.nlms_apply, S.nlms_sharded
            kw = dict(compat=True)
        st = jax.vmap(lambda _: init(jnp.float32))(jnp.arange(B))
        single = lambda f, r: jax.vmap(functools.partial(apply, dtype=jnp.float32, **kw))(f, r, st)[:2]
        want, got, ex, first, steady = _timed_pair(
            single, lambda f, r: shard(f, r, dmesh, dtype=jnp.float32), f, r)
        miss = sum(int((np.asarray(w) != np.asarray(g)).sum()) for w, g in zip(want, got))
        return record(f"four_{variant}_sessions", int(np.prod(f.shape)), first, steady,
                      "mismatches", miss, "== 0 (each session stays on one device)",
                      "float32, Precision.HIGHEST dots", miss == 0, **ex)

    def bnlms_time(ctx):
        from jeicyboodsp_tpu.ops import nlms as NL

        T = ctx["four_time_blocks"]
        far, near = _aec_signals(T * 1024, seed=16)
        f, r = jnp.asarray(far.reshape(T, 1024)), jnp.asarray(near.reshape(T, 1024))
        want, got, ex, first, steady = _timed_pair(
            lambda f, r: NL.bnlms_apply_timeparallel(f, r, dtype=jnp.float32),
            lambda f, r: S.bnlms_sharded_time(f, r, tmesh, dtype=jnp.float32), f, r)
        miss, ok = 0, True
        for w, g in zip(want, got):
            m, o = _lsb(w, g)
            miss, ok = miss + m, ok and o
        return record("four_bnlms_sharded_time", T * 1024, first, steady, "lsb_mismatches", miss,
                      "max |diff| <= 1 on <= 1% of samples", "float32, Precision.HIGHEST dots", ok, **ex)

    def speech(ctx):
        from jeicyboodsp_tpu.parallel import speech_sharded as SS
        from jeicyboodsp_tpu.pipelines.speech import speech_classify, speech_train

        T = ctx["four_speech_blocks"]
        C = 4
        rng = np.random.default_rng(8)
        tb = np.arange(1024) / FS
        audio = np.zeros((C, T, 1024), np.int16)
        for c in range(C):
            for b in range(T):
                sub, amp = 1.0 + 0.12 * (b % 4), 5000 + 900 * ((b // 4) % 3)
                sig = amp * np.sin(2 * np.pi * (300 + 400 * c) * sub * tb)
                sig += 2500 * np.sin(2 * np.pi * 2.3 * (300 + 400 * c) * sub * tb) + rng.normal(0, 200, 1024)
                audio[c, b] = np.clip(sig, -32768, 32767)
        smesh = make_mesh((2, n_dev // 2), ("expert", "data"), devices=devices)
        # float64, as the reference trains: EM on float32 features drifts
        # into degenerate covariances on some classes
        with jax.enable_x64(True):
            blocks = jnp.asarray(audio)
            want, got, ex, first, steady = _timed_pair(
                lambda b: speech_train(b, dtype=jnp.float64),
                lambda b: SS.speech_train_sharded(b, smesh, dtype=jnp.float64), blocks)
            err = 0.0
            for name, w, g in zip(("alpha", "mean", "cov", "eigvec"), want, got):
                w, g = np.asarray(w), np.asarray(g)
                if name == "eigvec":  # per-column sign freedom: |dot| == 1
                    dots = np.abs(np.einsum("ckij,ckij->ckj", w, g)
                                  / (np.linalg.norm(w, axis=-2) * np.linalg.norm(g, axis=-2) + 1e-300))
                    err = max(err, float(np.abs(dots - 1.0).max()) / 1e-8)
                else:
                    err = max(err, float((np.abs(w - g) / (1e-11 + 1e-9 * np.abs(w))).max()))
            al, me, cv, ev = got
            utts = jnp.concatenate([blocks, blocks], axis=0)
            scores = SS.speech_classify_sharded(utts, al, me, cv, ev[..., :4], smesh,
                                                dtype=jnp.float64)
            single = np.stack([np.asarray(speech_classify(utts[u], al, me, cv, ev[..., :4],
                                                          dtype=jnp.float64))
                               for u in range(utts.shape[0])])
        pred_miss = int((np.argmax(np.asarray(scores), 1) != np.argmax(single, 1)).sum())
        ok = err <= 1.0 and pred_miss == 0
        return record("four_speech_sharded", C * T * 1024, first, steady,
                      "train_max_err_over_tolerance; classify_decision_mismatches",
                      [float(f"{err:.3g}"), pred_miss],
                      "<= 1 (rtol 1e-9, eigvec |dot| within 1e-8); == 0",
                      "float64, Precision.HIGHEST dots", ok, **ex)

    return [
        ("four_enhance_sharded", enhance),
        ("four_enhance_sharded2d", enhance2d),
        ("four_fastconv_sharded", fastconv),
        ("four_mvdr_sharded_bins", mvdr_bins),
        ("four_geq_sharded", geq),
        ("four_bnlms_sessions", lambda c: sessions(c, "bnlms")),
        ("four_nlms_sessions", lambda c: sessions(c, "nlms")),
        ("four_bnlms_sharded_time", bnlms_time),
        ("four_speech_sharded", speech),
    ]


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------


class Context(dict):
    """Sizes plus a scratch directory and a cache of oracle outputs."""

    def __init__(self, sizes: dict, workdir: str):
        super().__init__(sizes)
        self.workdir = workdir
        self.cache = {}

    def path(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    def oracle(self, key, fn):
        if key not in self.cache:
            self.cache[key] = fn()
        return self.cache[key]


def run_phases(phases, sizes: dict, emit=print) -> list[dict]:
    """Run every phase (a failure is recorded and the run goes on);
    returns the records, each with ``ok``."""
    records = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
        ctx = Context(sizes, wd)
        for name, fn in phases:
            try:
                rec = fn(ctx)
            except Exception as e:  # recorded as a failed phase; main exits 1
                traceback.print_exc()
                rec = dict(phase=name, ok=False, error=f"{type(e).__name__}: {e}"[:400])
            records.append(rec)
            emit("phase " + json.dumps(rec))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths on four GPUs, each vs its one-device op")
    ap.add_argument("--out", default=None, help="also write the phase records here (JSON)")
    ns = ap.parse_args(argv)

    import jax

    from jeicyboodsp_tpu.utils.runtime import card_info, device_record, setup_compile_cache

    setup_compile_cache()
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 1
    want_devices = 4 if ns.four else 1
    if len(jax.devices()) < want_devices:
        print(f"chip_smoke: needs {want_devices} GPUs, found {len(jax.devices())}", file=sys.stderr)
        return 1
    for line in card_info():
        print(f"card: {line}")
    dev = device_record()
    print(f"jax: {jax.__version__} devices: {jax.devices()} device_kind: {dev['kind']} count: {dev['count']}")

    t0 = time.perf_counter()
    phases = four_phases(4) if ns.four else one_card_phases()
    records = run_phases(phases, FULL)
    failed = [r["phase"] for r in records if not r.get("ok")]
    print(f"phases: {len(records)} failed: {failed} wall_s: {time.perf_counter() - t0:.1f}")
    if ns.out:
        os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
        with open(ns.out, "w") as f:
            json.dump(dict(device=dev, card=card_info(), records=records), f, indent=1)
    if failed:
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

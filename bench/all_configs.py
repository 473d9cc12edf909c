#!/usr/bin/env python3
"""Per-configuration benchmark table on one GPU.

Every row times one jitted op at a batch a user would run: one warm-up
call (compilation, reported as ``setup_s``), then the median of ``REPS``
calls, each ended by ``block_until_ready``.  Rows with an f64 oracle also
report the SNR of a probe, and rows with an operation-count model
(``utils/profiling``) their share of the card's published roof.  The
output names the card (device_kind, count, power limit).  Nothing is
written to the repository; ``--out FILE`` saves the JSON.

    python bench/all_configs.py                 # every row
    python bench/all_configs.py mvdr fastconv   # only these rows
    python bench/all_configs.py tune            # BNLMS chunk sweep
"""

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPS = int(os.environ.get("BENCH_REPS", "10"))


def timed(fn, *args):
    """(out, setup_s, steady_s): one warm-up call, then the median of REPS."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    steady = float(np.median(ts))
    return out, max(first - steady, 0.0), steady


def cell(samples, fn, *args, roof=None, kind=None, unit="samples"):
    out, setup, steady = timed(fn, *args)
    rec = {f"{unit}_per_s": samples / steady, "steady_s": steady, "setup_s": setup}
    if roof is not None:
        b = roof.bound(kind)
        rec["roof_samples_per_s"] = b["speed_of_light_samples_per_s"]
        rec["roof_bound"] = b["bottleneck"]
        rec["pct_of_roof"] = roof.pct_of_roof(rec[f"{unit}_per_s"], kind)
    return out, rec


def rows(kind):
    """name -> zero-argument function returning the row dict."""
    import jax
    import jax.numpy as jnp

    from chip_smoke import speech_signal
    from jeicyboodsp_tpu.utils import profiling as prof
    from jeicyboodsp_tpu.utils.metrics import snr_db

    f32 = jnp.float32

    def enhance(mode):
        from chip_smoke import ENHANCE_OPS
        from jeicyboodsp_tpu.oracle import enhance as oenh
        from jeicyboodsp_tpu.ops.enhance import enhance_blocks

        T = 16384
        x = speech_signal(T * 512, seed=1)
        b = jnp.asarray(x.reshape(T, 512))
        want = oenh.run(x[: 256 * 512], mode)
        row = {}
        for v, kw in ENHANCE_OPS.items():
            roof = (prof.enhance_chain_roofline() if kw["fft_engine"] == "xla"
                    else prof.enhance_matmul_roofline(kw["fft_engine"]))
            fn = jax.jit(functools.partial(enhance_blocks, mode=mode, dtype=f32,
                                           use_assoc_scan=True, **kw))
            (out, mask), rec = cell(T * 512, fn, b, roof=roof, kind=kind)
            got = np.asarray(out)[np.asarray(mask)].reshape(-1)
            rec["snr_db"] = float(snr_db(want, got[: len(want)]))
            row[v] = rec
        return row

    def geq():
        from jeicyboodsp_tpu.ops.geq import geq_apply, geq_apply_fast, geq_coefficients, init_state

        b, a = geq_coefficients()
        B, N = 256, 48000
        x = jnp.asarray(np.stack([speech_signal(N, seed=s, fs=48000) for s in range(B)]))
        _, fast = cell(B * N, lambda x: geq_apply_fast(x, b, a, dtype=f32), x,
                       roof=prof.geq_roofline(), kind=kind)
        scan = jax.jit(jax.vmap(lambda xi: geq_apply(xi, b, a, init_state(), dtype=f32)[0]))
        _, compat = cell(B * 512, scan, x[:, :512])
        return {"linear_assoc_scan": fast, "compat_f32_scan_512_per_stream": compat}

    def fastconv():
        from jeicyboodsp_tpu.oracle import fastconv as ofc
        from jeicyboodsp_tpu.ops import fastconv as FC

        T = 2048
        x = speech_signal(T * 1024, seed=3)
        b = jnp.asarray(x.reshape(T, 1024))
        want = ofc.run(x[: 64 * 1024])
        Hr, Hi = FC.filter_spectrum(dtype=f32, real_fft=True)
        engines = {
            "xla": (lambda b: FC.fastconv_blocks(b, Hr, Hi, dtype=f32, real_fft=True),
                    prof.fastconv_roofline()),
            "sparse": (lambda b: FC.fastconv_blocks_sparse(b, dtype=f32), prof.fastconv_sparse_roofline()),
            "gemm": (lambda b: FC.fastconv_blocks_gemm(b, dtype=f32), prof.fastconv_gemm_roofline()),
            "gemm8": (lambda b: FC.fastconv_blocks_gemm_int8(b, terms=2), prof.fastconv_gemm8_roofline()),
            "gemm8hq": (lambda b: FC.fastconv_blocks_gemm_int8(b, terms=3),
                        prof.fastconv_gemm8_roofline(terms=3)),
        }
        row = {}
        for name, (fn, roof) in engines.items():
            out, rec = cell(T * 1024, jax.jit(fn), b, roof=roof, kind=kind)
            rec["snr_db"] = float(snr_db(want, np.asarray(out).reshape(-1)[: len(want)]))
            row[name] = rec
        return row

    def aec_signals(B, n):
        from chip_smoke import _aec_signals

        pairs = [_aec_signals(n, seed=100 + i) for i in range(B)]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    def bnlms():
        from jeicyboodsp_tpu.ops import nlms as NL

        B, T = 16, 512
        far, near = aec_signals(B, T * 1024)
        f, r = jnp.asarray(far.reshape(B, T, 1024)), jnp.asarray(near.reshape(B, T, 1024))
        st = jax.vmap(lambda _: NL.bnlms_init_state(f32))(jnp.arange(B))
        fn = jax.jit(lambda f, r: jax.vmap(functools.partial(NL.bnlms_apply, dtype=f32))(f, r, st)[0])
        _, seq = cell(B * T * 1024, fn, f, r, roof=prof.bnlms_xla_roofline(), kind=kind)
        Tt = 1024
        tp = jnp.asarray(np.tile(far[0], 2)[: Tt * 1024].reshape(Tt, 1024))
        tr = jnp.asarray(np.tile(near[0], 2)[: Tt * 1024].reshape(Tt, 1024))
        _, par = cell(Tt * 1024, lambda a, b: NL.bnlms_apply_timeparallel(a, b, dtype=f32), tp, tr)
        return {f"sequential_{B}_sessions": seq, "timeparallel_one_session": par}

    def nlms():
        from jeicyboodsp_tpu.ops import nlms as NL

        B, N = 16, 65536
        far, near = aec_signals(B, N)
        st = jax.vmap(lambda _: NL.nlms_init_state(f32))(jnp.arange(B))
        fn = jax.jit(lambda f, r: jax.vmap(functools.partial(NL.nlms_apply, dtype=f32))(f, r, st)[0])
        _, rec = cell(B * N, fn, jnp.asarray(far), jnp.asarray(near))
        return {f"scan_{B}_sessions": rec}

    def mvdr():
        from jeicyboodsp_tpu.oracle import mvdr as omv
        from jeicyboodsp_tpu.ops.mvdr import mvdr_blocks

        T = 8192
        xl = speech_signal(T * 512, seed=6)
        xr = np.clip(0.8 * xl.astype(np.float64) + np.random.default_rng(6).normal(0, 15, len(xl)),
                     -32768, 32767).astype(np.int16)
        bl, br = jnp.asarray(xl.reshape(T, 512)), jnp.asarray(xr.reshape(T, 512))
        want = omv.run(xl[: 64 * 512], xr[: 64 * 512])
        row = {}
        for eng in ("xla", "mxu", "mxu3"):
            fn = jax.jit(functools.partial(mvdr_blocks, d_time=0.0, dtype=f32, fft_engine=eng))
            (out, m), rec = cell(T * 512, fn, bl, br,
                                 roof=prof.mvdr_collapsed_roofline() if eng != "xla" else None, kind=kind)
            got = np.asarray(out)[np.asarray(m)].reshape(-1)
            rec["snr_db"] = float(snr_db(want, got[: len(want)]))
            row[eng] = rec
        return row

    def mfcc():
        from jeicyboodsp_tpu.oracle import mfcc as omf
        from jeicyboodsp_tpu.ops.features import dct_lifter_matrix, mel_matrix, mfcc_blocks

        T = 8192
        x = speech_signal(T * 1024, seed=9)
        b = jnp.asarray(x.reshape(T, 1024))
        mel_m, dct_m = jnp.asarray(mel_matrix(np.float32)), jnp.asarray(dct_lifter_matrix(np.float32))
        want = omf.run(x[: 32 * 1024])
        row = {}
        for eng in ("xla", "mxu"):
            fn = jax.jit(lambda b, e=eng: mfcc_blocks(b, mel_m, dct_m, dtype=f32, fft_engine=e))
            out, rec = cell(T * 1024, fn, b)
            rec["snr_db"] = float(snr_db(want, np.asarray(out)[1: 1 + len(want)]))
            row[eng] = rec
        return row

    def fft():
        from jeicyboodsp_tpu.ops.fft import roundtrip_blocks

        T = 16384
        b = jnp.asarray(speech_signal(T * 512, seed=7).reshape(T, 512))
        return {eng: cell(T * 512, lambda b, e=eng: roundtrip_blocks(b, dtype=f32, engine=e), b,
                          roof=prof.fft_roundtrip_roofline() if eng == "xla" else None, kind=kind)[1]
                for eng in ("radix2", "xla")}

    def pitch():
        from jeicyboodsp_tpu.ops.features import pitch_frames

        T = 16384
        pb = speech_signal(T * 512, seed=8).reshape(T, 512)
        frames = jnp.asarray(np.concatenate([np.concatenate([np.zeros((1, 512), np.int16), pb[:-1]]), pb], 1))
        row = {}
        for m, eng in ((1, "xla"), (1, "mxu"), (2, "xla"), (3, "xla"), (3, "mxu")):
            n = T if m != 2 else 2048
            fn = jax.jit(lambda fr, m=m, e=eng: pitch_frames(fr, method=m, dtype=f32, fft_engine=e)[0])
            roof = {(1, "mxu"): prof.wk_pitch_roofline(), (3, "mxu"): prof.wk_pitch3_roofline()}.get((m, eng))
            row[f"method{m}_{eng}"] = cell(n * 512, fn, frames[:n], roof=roof, kind=kind)[1]
        return row

    def lpc():
        from jeicyboodsp_tpu.ops.features import lpc_frames

        T = 8192
        lb = speech_signal(T * 256, seed=12).reshape(T, 256)
        fr = jnp.asarray(np.concatenate([np.concatenate([np.zeros((1, 256), np.int16), lb[:-1]]), lb], 1))
        return {s: cell(T * 256, lambda f, s=s: lpc_frames(f, dtype=f32, solver=s), fr,
                        roof=prof.lpc_roofline(), kind=kind)[1] for s in ("levinson", "solve")}

    def hmm_model():
        rng = np.random.default_rng(0)
        alpha = jnp.full((6, 4), 0.25, f32)
        mean = jnp.asarray(rng.normal(0, 1, (6, 4, 12)).astype(np.float32))
        cov = jnp.broadcast_to(jnp.eye(12, dtype=f32), (6, 4, 12, 12)) * 2.0
        eig = jnp.broadcast_to(jnp.eye(12, dtype=f32)[:, :4], (6, 4, 12, 4))
        trans = jnp.full((6, 6), 1.0 / 6, f32)
        return alpha, mean, cov, eig, trans

    def viterbi():
        from jeicyboodsp_tpu.models.hmm import viterbi as vit, viterbi_assoc, viterbi_batched

        p = hmm_model()
        rng = np.random.default_rng(1)
        F = 4096
        feats = jnp.asarray(rng.normal(0, 1, (F, 12)).astype(np.float32))
        U, Tv = 512, 512
        featsB = jnp.asarray(rng.normal(0, 1, (U, Tv, 12)).astype(np.float32))
        lens = jnp.full((U,), Tv, jnp.int32)
        return {
            "single_scan": cell(F, lambda f: vit(f, *p, compat=False)[0], feats, unit="frames")[1],
            "single_assoc": cell(F, lambda f: viterbi_assoc(f, *p)[0], feats, unit="frames")[1],
            f"batched_{U}x{Tv}": cell(U * Tv, lambda f: viterbi_batched(f, lens, *p, compat=False)[0],
                                      featsB, unit="frames")[1],
        }

    def gmm():
        from jeicyboodsp_tpu.models import gmm as MG

        C, F = 25, 512
        cls = []
        for c in range(C):
            r = np.random.default_rng(1000 + c)
            sub = r.normal(0, 10, 12) + r.normal(0, 4.0, (4, 12))
            cls.append(sub[(np.arange(F) // 4) % 4] + r.normal(0, 0.5, (F, 12)))
        fr = jnp.asarray(np.stack(cls).astype(np.float32))
        mk = jnp.ones((C, F), bool)
        (al, me, cv, ev), train = cell(C * F, jax.jit(MG.train_classes_batched), fr, mk, unit="frames")
        test = jnp.asarray(np.stack(cls)[:, :128].astype(np.float32))
        score = jax.jit(jax.vmap(lambda f: MG.score_frames_all_classes(f, al, me, cv, ev[..., :4])))
        return {"train_25_classes": train, "score_25x25": cell(C * 128, score, test, unit="frames")[1]}

    def speech():
        from jeicyboodsp_tpu.pipelines.speech import speech_classify, speech_train

        C, T = 25, 64
        audio = jnp.asarray(np.stack([speech_signal(T * 1024, seed=200 + c).reshape(T, 1024)
                                      for c in range(C)]))
        (al, me, cv, ev), train = cell(C * T * 1024, lambda a: speech_train(a, dtype=f32), audio)
        cls = cell(T * 1024, lambda u: speech_classify(u, al, me, cv, ev[..., :4], dtype=f32), audio[0])[1]
        return {"train": train, "classify_one_utterance": cls}

    def latency():
        from jeicyboodsp_tpu.ops.enhance import enhance_chunk, stream_init_state
        from jeicyboodsp_tpu.ops.nlms import bnlms_apply_block, bnlms_init_state

        st = stream_init_state(f32)
        blk = jnp.asarray(speech_signal(512, seed=1).reshape(1, 512))
        _, enh = cell(512, lambda s, b: enhance_chunk(s, b, mode="wiener", dtype=f32), st, blk)
        bst = bnlms_init_state(f32)
        xb = jnp.asarray(speech_signal(1024, seed=2))
        _, bn = cell(1024, lambda s, x: bnlms_apply_block(x, x, s, dtype=f32), bst, xb)
        return {"enhance_block_us": enh["steady_s"] * 1e6, "bnlms_block_us": bn["steady_s"] * 1e6}

    def tune():
        from jeicyboodsp_tpu.ops.nlms import bnlms_apply_timeparallel

        Tt = 1024
        far = jnp.asarray(speech_signal(Tt * 1024, seed=4).reshape(Tt, 1024))
        near = jnp.asarray(speech_signal(Tt * 1024, seed=5).reshape(Tt, 1024))
        return {f"bnlms_chunk_{c}": cell(Tt * 1024, lambda a, r, c=c: bnlms_apply_timeparallel(
            a, r, dtype=f32, chunk=c), far, near)[1] for c in (8, 16, 32, 64, 128)}

    return {
        "enhance_wiener": lambda: enhance("wiener"), "enhance_specsub": lambda: enhance("specsub"),
        "geq": geq, "fastconv": fastconv, "bnlms": bnlms, "nlms": nlms, "mvdr": mvdr, "mfcc": mfcc,
        "fft": fft, "pitch": pitch, "lpc": lpc, "viterbi": viterbi, "gmm": gmm, "speech": speech,
        "latency": latency, "tune": tune,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*", help="row names (default: all but tune)")
    ap.add_argument("--out", default=None)
    ns = ap.parse_args(argv)

    import jax

    from jeicyboodsp_tpu.utils.runtime import card_info, device_record, setup_compile_cache

    setup_compile_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"all_configs needs a GPU; JAX's default backend is {jax.default_backend()!r}")
    dev = device_record()
    table = rows(dev["kind"])
    names = ns.rows or [n for n in table if n != "tune"]
    unknown = set(names) - set(table)
    if unknown:
        raise SystemExit(f"unknown row(s) {sorted(unknown)}; valid: {sorted(table)}")
    result = {"device": dev, "card": card_info(), "reps": REPS, "rows": {}}
    for n in names:
        result["rows"][n] = table[n]()
        print(json.dumps({n: result["rows"][n]}), flush=True)
    if ns.out:
        with open(ns.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"device": dev, "card": result["card"]}))


if __name__ == "__main__":
    main()

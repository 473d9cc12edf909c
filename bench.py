#!/usr/bin/env python3
"""Headline benchmark: Wiener enhancement chain samples/s on one GPU.

Runs the f32 enhancement chain (``ops.enhance.enhance_blocks``) on the
16,384-block stream (8.39 M samples) for every engine, in one process and
in turns, and reports each engine's steady samples/s beside its SNR against
the float64 oracle on a probe.  Timing: one warm-up call compiles, then the
median of ``BENCH_REPS`` calls, each ended by ``block_until_ready``.
Prints ONE JSON line naming the card (device_kind, count, power limit).
Fails when JAX's default backend is not a GPU.

    python bench.py            # engines xla, xla_rfft, mxu, mxu3
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BENCH_T = 16384  # blocks per call (8.39 M samples, ~8.7 min at 16 kHz)
PROBE_T = 256  # blocks for the SNR probe
REPS = int(os.environ.get("BENCH_REPS", "20"))


def main():
    import jax
    import jax.numpy as jnp

    from chip_smoke import ENHANCE_OPS as VARIANTS, speech_signal
    from jeicyboodsp_tpu.oracle import enhance as oenh
    from jeicyboodsp_tpu.ops.enhance import enhance_blocks
    from jeicyboodsp_tpu.utils.metrics import snr_db
    from jeicyboodsp_tpu.utils.runtime import card_info, device_record, setup_compile_cache

    setup_compile_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's default backend is {jax.default_backend()!r}")

    x = speech_signal(BENCH_T * 512, seed=1)
    blocks = jax.device_put(jnp.asarray(x.reshape(BENCH_T, 512)))
    want = oenh.run(x[: PROBE_T * 512], "wiener")

    def call(v):
        return enhance_blocks(blocks, mode="wiener", dtype=jnp.float32,
                              use_assoc_scan=True, **VARIANTS[v])

    rows = {}
    for v in VARIANTS:
        t0 = time.perf_counter()
        out, mask = jax.block_until_ready(call(v))
        got = np.asarray(out)[np.asarray(mask)].reshape(-1)
        rows[v] = {"setup_s": time.perf_counter() - t0, "times": [],
                   "snr_db": float(snr_db(want, got[: len(want)]))}
    for _ in range(REPS):  # engines in turns, so drift hits all alike
        for v in VARIANTS:
            t0 = time.perf_counter()
            jax.block_until_ready(call(v))
            rows[v]["times"].append(time.perf_counter() - t0)
    for r in rows.values():
        t = float(np.median(r.pop("times")))
        r["steady_s"] = t
        r["samples_per_s"] = BENCH_T * 512 / t
    best = max(rows, key=lambda v: rows[v]["samples_per_s"])
    print(json.dumps({
        "metric": "enhance_chain_samples_per_sec",
        "value": rows[best]["samples_per_s"],
        "unit": "samples/s",
        "engine": best,
        "snr_db_vs_reference": rows[best]["snr_db"],
        "engines": rows,
        "blocks": BENCH_T,
        "device": device_record(),
        "card": card_info(),
    }))


if __name__ == "__main__":
    main()

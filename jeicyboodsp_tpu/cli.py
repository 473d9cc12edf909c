"""Command-line entry point.

Usage::

    python -m jeicyboodsp_tpu.cli <pipeline> <args...> [--fast] [--cpu]

Pipelines and their positional arguments mirror the reference programs:

    geq IN OUT                  7-band graphic EQ          (7Band_GEQ)
    fastconv IN OUT             RIR fast convolution       (Fast_Convolution...)
    wiener IN OUT               Wiener noise suppression   (WienerFilter_final)
    specsub IN OUT              spectral subtraction       (SpectralSubtraction_final)
    nlms IN REF EST ERR         per-sample NLMS AEC        (NormalLMS)
    bnlms IN REF EST ERR        block NLMS AEC             (BNLMS)
    mvdr LEFT RIGHT OUT         2-mic MVDR beamformer      (BeamForming_MVDR_ver1)
    fft IN OUT                  radix-2 FFT roundtrip      (FFTAlgorithm_ver2)
    pitch1|pitch2|pitch3 IN     pitch estimation           (PitchEstimation_*)
    mfcc LISTFILE               corpus MFCC extraction     (MFCCFeatureExtraction...)
    awgn IN OUT                 AWGN harness               (AnalysisAdditive...)
    gmm-train LIST MODEL        GMM training               (GMMAlgorithm_Train...)
    gmm-test LIST MODEL         GMM classification         (GMMAlgorithm_Test...)
    viterbi LIST MODEL          HMM/Viterbi decoding       (Viterbi_version1)
    stream IN OUT [MODE]        resumable streaming enhancement with
                                checkpoint/fault-injection flags (new)
"""

from __future__ import annotations

import argparse
import sys

ENGINES = ["xla", "mxu", "mxu3", "gemm", "gemm8", "gemm8hq"]


def main(argv=None):
    parser = argparse.ArgumentParser(prog="jeicyboodsp_tpu", description=__doc__)
    parser.add_argument("pipeline")
    parser.add_argument("args", nargs="*")
    parser.add_argument(
        "--fast",
        action="store_true",
        help="f32 speed path (compat quirks preserved, bit-level f64 fidelity relaxed)",
    )
    parser.add_argument("--cpu", action="store_true", help="force the CPU backend")
    parser.add_argument(
        "--engine",
        default=None,
        choices=ENGINES,
        help="transform engine for --fast pipelines that support it "
        "(xla = jnp.fft; mxu = matmul DFT as float32 dots; "
        "mxu3 = matmul DFT as bf16x3 dots; "
        "gemm = fastconv-only banded-Toeplitz GEMM (float32 dots), no spectral "
        "round-trip; gemm8 = fastconv-only int8 Toeplitz GEMM, ~77 dB; "
        "gemm8hq = its 3-term form, the fastconv --fast default). "
        "A pipeline refuses an engine it does not implement.",
    )
    parser.add_argument(
        "--verbose",
        action="store_true",
        help="reference-format compat diagnostics (L6 print-surface parity): "
        "NLMS per-block coefficients (NormalLMS.cpp:128), EM likelihood "
        "before/after (GMMAlgorithm_Train_Auto_ver2.cpp:332), Viterbi "
        "per-time max accumulated probs (Viterbi_version1.cpp:222), FFT op "
        "counts (FFTAlgorithm_ver2.cpp:148); supported by "
        "nlms / gmm-train / viterbi / fft",
    )
    parser.add_argument("--ckpt", default=None, help="stream: checkpoint file (resume if present)")
    parser.add_argument("--ckpt-every", type=int, default=4, help="stream: chunks between checkpoints")
    parser.add_argument("--chunk-blocks", type=int, default=4, help="stream: blocks per chunk")
    parser.add_argument("--crash-after", type=int, default=None,
                        help="stream: fault injector -- hard-exit after N chunks")
    ns = parser.parse_args(argv)

    import jax

    from jeicyboodsp_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()
    if ns.cpu:
        jax.config.update("jax_platforms", "cpu")
    if not ns.fast:
        # compat mode is f64 (c128 FFTs) on the default device: on the H100
        # every pipeline's compat path meets the exactness COVERAGE.md
        # documents for it (chip_smoke.py's compat_* phases, PERF.md)
        jax.config.update("jax_enable_x64", True)

    from jeicyboodsp_tpu.pipelines import PIPELINES

    if ns.pipeline not in PIPELINES:
        print(f"unknown pipeline {ns.pipeline!r}; choices: {sorted(PIPELINES)}")
        return 2

    kw = {}
    if ns.verbose:
        if ns.pipeline not in ("nlms", "gmm-train", "viterbi", "fft"):
            print(f"--verbose is not supported by pipeline {ns.pipeline!r}")
            return 2
        kw["verbose"] = True
    if ns.fast:
        import jax.numpy as jnp

        kw["dtype"] = jnp.float32
        if ns.engine:
            kw["fft_engine"] = ns.engine
    if ns.pipeline == "stream":
        kw.update(
            ckpt=ns.ckpt, ckpt_every=ns.ckpt_every,
            chunk_blocks=ns.chunk_blocks, crash_after_chunks=ns.crash_after,
        )
    PIPELINES[ns.pipeline](*ns.args, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())

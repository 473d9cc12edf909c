"""Pipeline configurations with the reference programs' values as defaults.

Every knob is a compile-time ``#define`` in the reference; the originating
constant is cited so compat stays auditable.  ``compat="reference"``
reproduces the reference output (f64, quirks on); ``compat="fast"`` runs the
f32 speed path on the accelerator (same math, relaxed bit-level quirks).
"""

from __future__ import annotations

import dataclasses

# Per-engine fidelity contract: SNR floors in dB vs the f64 oracle on the
# standard speech+noise probe, asserted on the CPU by
# tests/test_engine_matrix.py and on the GPU by chip_smoke.py.  "algo" is
# the dot algorithm the engine asks for on float32 operands (see
# ops/dft.py); "floor" is the contract.  Measured values live in PERF.md.
ENGINE_FIDELITY = {
    # enhance chain (wiener/specsub)
    ("enhance", "xla"): dict(floor=95.0, algo="jnp.fft (cuFFT)"),
    ("enhance", "mxu"): dict(floor=90.0, algo="matmul DFT, F32_F32_F32 (HIGHEST)"),
    ("enhance", "mxu3"): dict(floor=85.0, algo="matmul DFT, BF16_BF16_F32_X3"),
    # fastconv (--fast default engine: gemm8hq)
    ("fastconv", "xla"): dict(floor=88.0, algo="batched jnp.fft rfft"),
    ("fastconv", "gemm"): dict(floor=95.0, algo="Toeplitz GEMM, Precision.HIGHEST"),
    ("fastconv", "gemm8"): dict(
        floor=70.0, algo="int8 Toeplitz GEMM (4 s8xs8->s32 dots); bounded by "
        "the operator-split residual -- the sparse RIR concentrates it",
    ),
    ("fastconv", "gemm8hq"): dict(
        floor=85.0, algo="3-term int8 Toeplitz GEMM (5 s8xs8->s32 dots), "
        "the --fast default",
    ),
    # mvdr / mfcc (engine changes only the DFT GEMMs)
    ("mvdr", "xla"): dict(floor=80.0, algo="jnp.fft (cuFFT)"),
    ("mvdr", "mxu"): dict(floor=80.0, algo="matmul DFT, Precision.HIGHEST; theta=0 collapse is exact"),
    ("mvdr", "mxu3"): dict(floor=80.0, algo="matmul DFT, BF16_BF16_F32_X3; theta=0 collapse is exact"),
    ("mfcc", "xla"): dict(floor=100.0, algo="jnp.fft (cuFFT)"),
    # mfcc offers no mxu3: bf16x3 measured 80.2 dB on the H100 (PERF.md),
    # the log stage amplifies the basis residual at spectral valleys
    ("mfcc", "mxu"): dict(floor=100.0, algo="matmul DFT, Precision.HIGHEST"),
}


@dataclasses.dataclass
class GEQConfig:
    """7Band_GEQ.cpp:33-57."""

    sample_rate: float = 48000.0  # :33
    block_len: int = 512  # :43
    q: float = 4.318  # :45
    center_freqs: tuple = (44.0, 125.0, 250.0, 500.0, 2000.0, 6000.0, 11313.0)  # :47
    gains_db: tuple = (12.0, 12.0, 0.0, 0.0, 3.0, 0.0, -12.0)  # :51-57
    compat: str = "reference"


@dataclasses.dataclass
class FastConvConfig:
    """Fast_Convolution_Based_3DAudio_Impl.cpp:47-49 + FilterCoefficient.h."""

    block_size: int = 1024  # :47
    fft_size: int = 8192  # :48
    filter_length: int = 7169  # FilterCoefficient.h:1
    compat: str = "reference"


@dataclasses.dataclass
class EnhanceConfig:
    """WienerFilter_final.cpp:32-45 / SpectralSubtraction_final.cpp:48-56."""

    mode: str = "wiener"  # or "specsub"
    block_len: int = 512  # :43
    fft_size: int = 1024  # :44
    noise_frames: int = 10  # :45
    energy_threshold: float = 700.0  # :32
    zcr_threshold: float = 200.0  # :33
    compat: str = "reference"


@dataclasses.dataclass
class AECConfig:
    """NormalLMS.cpp:29-33 / BNLMS.cpp:33-37."""

    variant: str = "nlms"  # or "bnlms"
    block_len: int = 1024
    taps: int = 256  # nlms; bnlms: 128
    mu: float = 0.0001  # nlms; bnlms: 0.01
    eps: float = 0.0001  # nlms; bnlms: 1e-5
    compat: str = "reference"


@dataclasses.dataclass
class MVDRConfig:
    """BeamForming_MVDR_ver1.cpp:34-41."""

    block_len: int = 512
    fft_len: int = 1024
    keep_len: int = 511  # :37 (quirk: 511, not 512)
    mic_distance_cm: float = 800.0  # :41
    speed_of_sound_cm_s: float = 34000.0  # :40
    steer_angle_rad: float = 0.0  # :57 -> dTime = 0
    compat: str = "reference"


@dataclasses.dataclass
class SpeechConfig:
    """MFCC -> GMM -> Viterbi chain constants.

    MFCCFeatureExtraction_auto_version1.cpp:23-33,
    GMMAlgorithm_Train_Auto_ver2.cpp:20-25, Viterbi_version1.cpp:22-28.
    """

    mfcc_len: int = 12
    mel_channels: int = 38
    lifter_len: int = 22
    num_classes: int = 25
    num_mixtures: int = 4
    em_iterations: int = 3
    pca_train: int = 8
    pca_test: int = 4  # the train/test layout mismatch is emulated in
    num_states: int = 6  # serialization.read_as_test_layout
    compat: str = "reference"

"""JeicybooDSP: an accelerator-native audio DSP framework in JAX.

A from-scratch reimplementation of the capabilities of phoenix163/JeicybooDSP
(17 standalone C++ block-streaming DSP programs) as an idiomatic JAX / XLA
framework that runs on one NVIDIA H100 or a multi-GPU host:

- ``ops``       pure-functional JAX DSP ops (STFT, biquad EQ, overlap-save
                convolution, NLMS/BNLMS, MVDR, Wiener/spectral-subtraction,
                VAD, noise estimation, MFCC/LPC/pitch, AWGN).
- ``models``    batched GMM (k-means + EM + PCA) and HMM/Viterbi.
- ``parallel``  mesh construction, halo exchange (ppermute), reductions (psum)
                for multi-chip / multi-host sharding over time and channels.
- ``pipelines`` the five benchmark configurations as composable jitted graphs.
- ``io``        WAV/PCM16 stream I/O and block framing.
- ``oracle``    bit-faithful NumPy transliterations of the reference programs
                (float64 + int16 truncation semantics) used as golden tests.
- ``utils``     C-numeric emulation (short casts), config, logging, metrics.

Numerical fidelity contract: every pipeline has a ``compat`` mode that
reproduces the reference program's output (including its documented quirks)
to >= 60 dB SNR, and a ``fast`` mode free to use f32/bf16 and corrected math.
The package name keeps the original project's suffix.
"""

__version__ = "0.1.0"

from jeicyboodsp_tpu.utils import cnum  # noqa: F401

"""Profiling + roofline estimation (SURVEY §5 tracing/profiling).

``trace`` wraps ``jax.profiler`` for device traces; the ``*_roofline``
functions give the statically-known operation and byte counts of each
implemented algorithm (per processed block), so a measured samples/s can be
placed against a card's published peaks.  Peaks live in one table keyed by
``device_kind``; a device that is not in it is an error, never a default.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np

# Published dense peaks (no sparsity) per device_kind.  Units: operations/s
# per compute class, bytes/s of device memory.
#   NVIDIA H100 SXM5 80GB (device_kind "NVIDIA H100 80GB HBM3"): NVIDIA H100
#   Tensor Core GPU datasheet -- 989 TFLOP/s bf16, 495 TF32, 1,979 TOP/s
#   int8 (tensor cores), 67 TFLOP/s float32 and 34 TFLOP/s float64 outside
#   the tensor cores, 3.35 TB/s HBM3.  These assume the 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12,
        "tf32": 495e12,
        "int8": 1979e12,
        "fp32": 67e12,
        "fp64": 34e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU datasheet (SXM5, dense, 700 W)",
    },
}


def peaks_for(device_kind: str) -> dict:
    """The peaks row for ``device_kind``; raises KeyError for unknown cards."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


@contextmanager
def trace(logdir: str):
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class Roofline:
    """Operations and device-memory bytes per block of ``samples_per_block``.

    ``unit`` names the compute class the operations run on (a key of
    :data:`PEAKS`): "fp32" for float32 work outside the tensor cores
    (elementwise, FFTs, HIGHEST-precision dots), "bf16" for tensor-core
    bf16 products (a bf16x3 dot counts 3 products per MAC), "int8" for
    s8 x s8 -> s32 dots.
    """

    flops_per_block: float
    hbm_bytes_per_block: float
    samples_per_block: int
    unit: str = "fp32"

    def bound(self, device_kind: str) -> dict:
        """Samples/s ceilings on ``device_kind`` at its published peaks."""
        peaks = peaks_for(device_kind)
        t_compute = self.flops_per_block / peaks[self.unit]
        t_mem = self.hbm_bytes_per_block / peaks["hbm_bytes_per_s"]
        t = max(t_compute, t_mem)
        return {
            "compute_bound_samples_per_s": self.samples_per_block / t_compute,
            "memory_bound_samples_per_s": self.samples_per_block / t_mem,
            "speed_of_light_samples_per_s": self.samples_per_block / t,
            "bottleneck": "compute" if t_compute > t_mem else "memory",
        }

    def pct_of_roof(self, measured_sps: float, device_kind: str) -> float:
        """Measured samples/s as a % of this model's speed of light."""
        sol = self.bound(device_kind)["speed_of_light_samples_per_s"]
        return 100.0 * measured_sps / sol


def enhance_chain_roofline(block=512, fft=1024, dtype_bytes=4) -> Roofline:
    """``jnp.fft`` engine, per 512-sample block: one rfft + one irfft
    (5 N log2 N flops each), VAD + gain elementwise, ~6 device-memory
    passes over the frame."""
    nlog = fft * np.log2(fft)
    flops = 2 * 5 * nlog + 30 * fft
    bytes_ = 6 * fft * dtype_bytes
    return Roofline(flops, bytes_, block, unit="fp32")


def enhance_matmul_roofline(engine: str = "mxu3", block=512, fft=1024) -> Roofline:
    """Matmul-DFT engines (ops/enhance._enhance_fast_mxu), per block: the
    window-folded forward GEMMs (1024 x (2 x 512 + 1) MACs) and the
    symmetry-halved inverse (2 x 512 x 512 + 512 MACs).  mxu runs them as
    float32 dots, mxu3 as bf16x3 (3 tensor-core products per MAC).  Bytes:
    int16 in/out plus ~8 float32 (T, 512) planes written and read once."""
    macs = fft * (2 * 512 + 1) + 2 * 512 * 512 + 512
    if engine == "mxu":
        return Roofline(2 * macs, 2 * block * 2 + 8 * 512 * 4 * 2, block, unit="fp32")
    return Roofline(3 * 2 * macs, 2 * block * 2 + 8 * 512 * 4 * 2, block, unit="bf16")


def fastconv_roofline(block=1024, fft=8192, dtype_bytes=4) -> Roofline:
    """Tiled ``jnp.fft`` rfft overlap-save path."""
    nlog = fft * np.log2(fft)
    flops = 2 * 5 * nlog + 8 * fft
    bytes_ = 6 * fft * dtype_bytes
    return Roofline(flops, bytes_, block, unit="fp32")


def fastconv_gemm8_roofline(block=1024, seg=8192, batch=2048, terms=2) -> Roofline:
    """int8 Toeplitz engine: 4 (gemm8) or 5 (gemm8hq) s8 x s8 -> s32 dots of
    (T, 8192) @ (8192, 1024) per hop; bytes: the int8 segment planes, the
    output, and the int8 operator amortized over the batch."""
    ndots = {2: 4, 3: 5}[terms]
    flops = ndots * 2 * seg * block
    bytes_ = 2 * seg + block * 2 + terms * seg * block / batch
    return Roofline(flops, bytes_, block, unit="int8")


def fastconv_gemm_roofline(block=1024, seg=8192, batch=2048) -> Roofline:
    """Banded-Toeplitz GEMM engine: (T, 8192) @ (8192, 1024) per hop as a
    float32 (HIGHEST) dot.  Bytes: the float32 segment row + output + the
    33.5 MB operator amortized over the batched rows."""
    flops = 2 * seg * block
    bytes_ = (seg + block) * 4 + seg * block * 4 / batch
    return Roofline(flops, bytes_, block, unit="fp32")


def fastconv_sparse_roofline(block=1024, taps=70) -> Roofline:
    """Sparse direct path: a chain of 70 ``y += c * slice`` updates over the
    flat signal, which XLA fuses into one pass on the GPU: an int16 read,
    a float32 staging copy written and read, an int16 write per sample."""
    flops = 2 * taps * block
    bytes_ = block * (2 + 4 + 4 + 2)
    return Roofline(flops, bytes_, block, unit="fp32")


def geq_roofline(block=512, bands=7, dtype_bytes=4) -> Roofline:
    """Fast-linear GEQ as associative state-space scans (ops/geq.
    geq_apply_fast): per band ~5 FIR ops/sample plus ~2 combines/sample,
    each a 2x2 @ 2x2 + 2x2 @ 2 affine compose (~20 ops)."""
    flops = block * bands * (5 + 2 * 20)
    bytes_ = 2 * block * dtype_bytes
    return Roofline(flops, bytes_, block, unit="fp32")


def mvdr_collapsed_roofline(block=512) -> Roofline:
    """theta=0 structural collapse (ops/mvdr.py): per 512-sample block -- VAD
    window + energy, two pair energies, the w0*l + w1*r mix, int16 clamp.
    Bytes: 2 int16 reads + 1 int16 write + ~3 float32 intermediates."""
    flops = (6 + 4 + 3 + 2) * block
    bytes_ = (2 + 1) * block * 2 + 3 * block * 4
    return Roofline(flops, bytes_, block, unit="fp32")


def lpc_roofline(block=256, window=512, order=12) -> Roofline:
    """Per 256-sample hop (ops/features.lpc_frames): 13 autocorrelation
    lags via roll + mask + reduce (each lag a rolled copy: ~2 passes of the
    window), plus ~300 flops of Levinson per frame."""
    flops = 2 * window + 13 * 4 * window + 300
    bytes_ = 13 * 2 * window * 4 + window * 4 + order * 4
    return Roofline(flops, bytes_, block, unit="fp32")


def wk_pitch_roofline(block=512, proc=1024) -> Roofline:
    """Wiener-Khinchin pitch method 1 (mxu engines): one rdft(1024) (2 planes
    x 1024 x 513 MACs) + one cosine autocorrelation matmul (513 x 512
    MACs), float32 dots (the argmax over near-equal peaks needs them)."""
    macs = 2 * proc * (proc // 2 + 1) + (proc // 2 + 1) * block
    return Roofline(2 * macs, (proc + block) * 4, block, unit="fp32")


def wk_pitch3_roofline(block=512, proc=1024) -> Roofline:
    """Method 3: the zero-padded 2048-pt rdft contracted over the 1024 real
    samples (1024 x 1024 bases + rank-1 Nyquist terms), then a 1024 x 512
    power -> autocorrelation matmul; float32 dots."""
    macs = 2 * proc * proc + proc * block
    return Roofline(2 * macs, (proc + block) * 4, block, unit="fp32")


def fft_roundtrip_roofline(block=512) -> Roofline:
    """FFT roundtrip (ops/fft.roundtrip_blocks, engine "xla"): one complex
    fft + ifft per 512-sample block with the spectrum materialized between
    them."""
    nlog = block * np.log2(block)
    flops = 2 * 5 * nlog
    bytes_ = block * (2 + 2 + 8 + 8 + 4 + 4)
    return Roofline(flops, bytes_, block, unit="fp32")


def bnlms_xla_roofline(taps=128) -> Roofline:
    """Vmapped XLA BNLMS (ops/nlms.bnlms_apply): per sample per stream the
    (1024, 128) Toeplitz window is materialized and read back by the
    estimate matmul, the norm reduction and the gradient matmul -- ~3
    float32 passes over 128 taps/sample."""
    return Roofline(6 * taps, 3 * taps * 4, 1, unit="fp32")

"""End-to-end SHARDED speech pipeline (SURVEY §3.4 on a device mesh).

The single-jit pipeline in :mod:`jeicyboodsp_tpu.pipelines.speech` runs the
reference's three chained programs (MFCC -> GMM train -> decode,
``MFCCFeatureExtraction_auto_version1.cpp`` / ``GMMAlgorithm_Train_Auto_ver2.cpp``
/ ``Viterbi_version1.cpp``) as one graph on one device.  This module is the
mesh form -- the framework's flagship *training* story:

- :func:`speech_train_sharded` -- audio (C, T, 1024) sharded classes x time
  over an ("expert", "data") mesh.  MFCC frames are extracted shard-locally
  with a 512-sample ``ppermute`` halo (the keep-buffer of
  ``MFCCFeatureExtraction_auto_version1.cpp:205``); K-means and the 3 EM
  iterations (``GMMAlgorithm_Train_Auto_ver2.cpp:255-438``) run with their
  sufficient statistics -- assignment counts/sums, responsibility sums,
  weighted feature sums, weighted scatters -- ``psum``-reduced over the
  time/frame shards (the reference's only global reductions, SURVEY §5);
  classes never communicate (expert parallelism), so PCA export is local.
- :func:`speech_classify_sharded` -- utterance-data-parallel classification
  (``GMMAlgorithm_Test_Auto_ver2.cpp:151-162``): each device scores its
  utterances against the replicated 25-class model, no collectives.
- :func:`speech_decode_sharded` -- utterance-data-parallel corpus Viterbi
  (``Viterbi_version1.cpp:157-246`` semantics via models.hmm).

Equivalence with the single-device pipeline is exact up to psum summation
order (tests/test_speech_sharded.py pins it at f64 rtol 1e-10).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from jeicyboodsp_tpu.models.gmm import (
    NUM_OF_MIXTURE,
    PCA_LEN_TRAIN,
    THRESHOLD_OF_DISTANCE,
    _pca_prob,
    pca_export,
)
from jeicyboodsp_tpu.oracle.gmm import EM_ITERATIONS
from jeicyboodsp_tpu.oracle.mfcc import KEEP_LEN, WINDOW_LEN
from jeicyboodsp_tpu.ops.features import dct_lifter_matrix, mel_matrix, mfcc_frames
from jeicyboodsp_tpu.parallel.halo import left_halo

# float32 dots stay float32 on the GPU (its default f32 dot is TF32)
_HI = jax.lax.Precision.HIGHEST
_mm = functools.partial(jnp.matmul, precision=_HI)


def _mel_dct(dtype):
    npdtype = np.float32 if dtype == jnp.float32 else np.float64
    return jnp.asarray(mel_matrix(npdtype)), jnp.asarray(dct_lifter_matrix(npdtype))


def _mfcc_local(blocks_loc, mel_m, dct_m, dtype, data_axis, fft_engine="xla"):
    """Shard-local MFCC over (..., T_loc, 1024) time-sharded blocks.

    The first frame of a shard needs the previous shard's trailing 512
    samples (the in-signal keep buffer) -- one ppermute halo; shard 0 gets
    zeros, exactly mfcc_blocks' zero-padded start."""
    *lead, T_loc, B = blocks_loc.shape
    flat = blocks_loc.reshape(*lead, T_loc * B)
    # halo along the (sharded) time axis: move it to axis 0 for left_halo
    moved = jnp.moveaxis(flat, -1, 0)  # (T_loc*B, *lead)
    halo = jnp.moveaxis(left_halo(moved, KEEP_LEN, data_axis), 0, -1)
    flat = jnp.concatenate([halo, flat], axis=-1)  # (..., KEEP + T_loc*B)
    rows = flat.reshape(*lead, 2 * T_loc + 1, KEEP_LEN)
    frames = jnp.concatenate([rows[..., :-1, :], rows[..., 1:, :]], axis=-1)
    feats = mfcc_frames(
        frames.reshape(-1, WINDOW_LEN), mel_m, dct_m, dtype=dtype, fft_engine=fft_engine
    )
    return feats.reshape(*lead, 2 * T_loc, feats.shape[-1])


def _vary(x, axes):
    """Mark x as varying over the named mesh axes (shard_map vma typing:
    loop carries must enter with the same varying-type they exit with)."""
    if not axes:
        return x
    return jax.lax.pcast(x, tuple(axes), to="varying")


def _kmeans_psum(frames, mask, init_means, data_axis, extra_axes=()):
    """models.gmm.kmeans with its two global reductions (assignment cost,
    per-cluster count/sum) psum'd over the frame shards.  Identical control
    flow: the convergence flag derives from the psum'd cost, so every
    device iterates in lockstep."""
    N = frames.shape[0]
    dtype = frames.dtype

    def dist(means):
        return jnp.sum((frames[:, None, :] - means[None, :, :]) ** 2, axis=2)

    def assign(sel, means):
        d = dist(means)
        arg = (NUM_OF_MIXTURE - 1) - jnp.argmin(d[:, ::-1], axis=1)
        sel = sel | (jax.nn.one_hot(arg, NUM_OF_MIXTURE, dtype=bool) & mask[:, None])
        cost = jax.lax.psum(jnp.sum(jnp.where(sel, d, 0.0)), data_axis)
        return sel, cost

    def cond(carry):
        count, converged, *_ = carry
        return ~converged

    def body(carry):
        count, _, sel, means, cost_before = carry
        sel, cost = assign(sel, means)
        count = count + 1
        keep_going = (count == 1) | (jnp.abs(cost - cost_before) >= THRESHOLD_OF_DISTANCE)
        cnt = jax.lax.psum(jnp.sum(sel, axis=0).astype(dtype), data_axis)
        sums = jax.lax.psum(_mm(sel.astype(dtype).T, frames), data_axis)
        new_means = jnp.where(cnt[:, None] > 0, sums / jnp.maximum(cnt, 1.0)[:, None], 0.0)
        means_next = jnp.where(keep_going, new_means, means)
        return (count, ~keep_going, sel, means_next, jnp.where(keep_going, cost, cost_before))

    carry = (
        jnp.zeros((), jnp.int32),
        _vary(jnp.zeros((), bool), extra_axes),  # converged: from psum'd cost
        _vary(jnp.zeros((N, NUM_OF_MIXTURE), bool), (data_axis, *extra_axes)),
        init_means,
        _vary(jnp.zeros((), dtype), extra_axes),
    )
    _, _, sel, means, _ = jax.lax.while_loop(cond, body, carry)

    cnt = jax.lax.psum(jnp.sum(sel, axis=0).astype(dtype), data_axis)
    diff = frames[:, None, :] - means[None, :, :]
    w = sel.astype(dtype)
    scatter = jax.lax.psum(jnp.einsum("nk,nki,nkj->kij", w, diff, diff, precision=_HI), data_axis)
    return means, scatter / cnt[:, None, None]


def _em_step_psum(frames, mask, alpha, mean, cov, data_axis):
    """models.gmm.em_step (compat non-reset accumulators) with the M-step
    sufficient statistics psum'd over the frame shards."""
    n = jax.lax.psum(jnp.sum(mask).astype(frames.dtype), data_axis)
    probs = jnp.stack(
        [_pca_prob(frames, mean[k], cov[k], PCA_LEN_TRAIN) for k in range(NUM_OF_MIXTURE)],
        axis=1,
    )
    w = probs * alpha[None, :]
    w = w / jnp.sum(w, axis=1, keepdims=True)
    w = jnp.where(mask[:, None], w, 0.0)

    n_of_key = alpha + jax.lax.psum(jnp.sum(w, axis=0), data_axis)
    alpha_new = n_of_key / n
    mean_new = (mean + jax.lax.psum(_mm(w.T, frames), data_axis)) / n_of_key[:, None]
    diff = frames[:, None, :] - mean_new[None, :, :]
    scatter = jax.lax.psum(jnp.einsum("nk,nki,nkj->kij", w, diff, diff, precision=_HI), data_axis)
    return alpha_new, mean_new, scatter / n_of_key[:, None, None]


def speech_train_sharded(
    class_blocks,
    mesh,
    expert_axis: str = "expert",
    data_axis: str = "data",
    dtype=jnp.float32,
    fft_engine: str = "xla",
    iterations: int = EM_ITERATIONS,
):
    """(C, T, 1024) int16 audio -> PCA-exported GMM params per class, with
    classes sharded over `expert_axis` and time/frames over `data_axis`.

    Matches :func:`jeicyboodsp_tpu.pipelines.speech.speech_train` up to psum
    summation order.  C must divide the expert axis size, T the data axis
    size.
    """
    C, T, _ = class_blocks.shape
    ne, nd = mesh.shape[expert_axis], mesh.shape[data_axis]
    if C % ne or T % nd:
        raise ValueError(f"C={C} / T={T} not divisible by mesh ({ne}, {nd})")
    mel_m, dct_m = _mel_dct(dtype)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(expert_axis, data_axis, None),),
        out_specs=(P(expert_axis), P(expert_axis), P(expert_axis), P(expert_axis)),
    )
    def run(blocks_loc):  # (C_loc, T_loc, 1024)
        feats = _mfcc_local(blocks_loc, mel_m, dct_m, dtype, data_axis, fft_engine)

        def train_one(f):  # (N_loc, 12), frames time-sharded over data_axis
            mask = jnp.ones(f.shape[0], bool)
            # seed means = GLOBAL frames[0,4,8,12] (train_single_file): they
            # live on data-rank 0; psum broadcasts them
            didx = jax.lax.axis_index(data_axis)
            cand = f[jnp.arange(NUM_OF_MIXTURE) * 4]
            init_means = jax.lax.psum(
                jnp.where(didx == 0, cand, jnp.zeros_like(cand)), data_axis
            )
            mean, cov = _kmeans_psum(f, mask, init_means, data_axis, (expert_axis,))
            alpha = _vary(
                jnp.full((NUM_OF_MIXTURE,), 1.0 / NUM_OF_MIXTURE, f.dtype),
                (expert_axis,),
            )

            def body(_, carry):
                a, m, c = carry
                return _em_step_psum(f, mask, a, m, c, data_axis)

            alpha, mean, cov = jax.lax.fori_loop(0, iterations, body, (alpha, mean, cov))
            return pca_export(alpha, mean, cov)

        return jax.vmap(train_one)(feats)

    return run(class_blocks)


def speech_classify_sharded(
    utt_blocks, alphas, means, covs, eigvecs4, mesh, axes=("expert", "data"),
    dtype=jnp.float32, fft_engine: str = "xla",
):
    """(U, T, 1024) utterances data-parallel over the whole mesh ->
    (U, C) class log-likelihood scores (argmax = decision).  The model is
    replicated; there are no collectives -- pure throughput scaling."""
    from jeicyboodsp_tpu.models.gmm import score_frames_all_classes
    from jeicyboodsp_tpu.ops.features import mfcc_blocks

    U = utt_blocks.shape[0]
    ntot = int(np.prod([mesh.shape[a] for a in axes]))
    if U % ntot:
        raise ValueError(f"U={U} not divisible by mesh size {ntot}")
    mel_m, dct_m = _mel_dct(dtype)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axes), P(), P(), P(), P()),
        out_specs=P(axes),
    )
    def run(blocks_loc, al, me, cv, ev):
        feats = mfcc_blocks(blocks_loc, mel_m, dct_m, dtype=dtype, fft_engine=fft_engine)
        return jax.vmap(
            lambda f: score_frames_all_classes(f, al, me, cv, ev)
        )(feats)

    return run(utt_blocks, alphas, means, covs, eigvecs4)


def speech_decode_sharded(
    utt_blocks, alpha, mean, cov, eigvec4, trans, mesh, axes=("expert", "data"),
    dtype=jnp.float32,
):
    """(U, T, 1024) utterances -> (paths (U, 2T-?), scores (U,)): corpus
    Viterbi decode data-parallel over utterances (the reference decodes one
    utterance per file read, Viterbi_version1.cpp:91-137; the mesh batches
    the corpus)."""
    from jeicyboodsp_tpu.models.hmm import _viterbi_batched_jit
    from jeicyboodsp_tpu.ops.features import mfcc_blocks

    U = utt_blocks.shape[0]
    ntot = int(np.prod([mesh.shape[a] for a in axes]))
    if U % ntot:
        raise ValueError(f"U={U} not divisible by mesh size {ntot}")
    mel_m, dct_m = _mel_dct(dtype)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axes), P(), P(), P(), P(), P()),
        out_specs=(P(axes), P(axes)),
    )
    def run(blocks_loc, al, me, cv, ev, tr):
        feats = mfcc_blocks(blocks_loc, mel_m, dct_m, dtype=dtype)
        lengths = jnp.full((feats.shape[0],), feats.shape[1], jnp.int32)
        return _viterbi_batched_jit(feats, lengths, al, me, cv, ev, tr, compat=False)

    return run(utt_blocks, alpha, mean, cov, eigvec4, trans)

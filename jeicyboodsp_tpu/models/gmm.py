"""GMM training (K-means + EM + PCA) and scoring, batched on the device.

Reference: ``GMMAlgorithm_Train_Auto_ver2.cpp`` / ``GMMAlgorithm_Test_Auto_ver2.cpp``
(oracle: :mod:`jeicyboodsp_tpu.oracle.gmm` -- all compat quirks listed there).

Device mapping vs the reference's scalar loops:
- distances/projections/responsibility sums are matmuls, all float32/64
  dots at ``Precision.HIGHEST`` (the GPU's default f32 dot is TF32, and
  the classification is chaotic under small perturbations);
- the per-frame-per-mixture eigendecomposition in the reference's E-step hot
  loop (``:272`` calling ``probability`` -> ``EigenSolver`` per call!) is
  loop-invariant and hoisted to ONE batched ``jnp.linalg.eigh`` per mixture
  per iteration -- identical values, asymptotically faster;
- K-means' data-dependent convergence loop is a ``lax.while_loop`` with
  fixed-shape carry (the accumulating Selection matrix is part of the carry,
  faithfully never cleared);
- everything vmaps over classes given padded (num_classes, N, 12) features
  with a frame mask.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jeicyboodsp_tpu.oracle.gmm import (
    EM_ITERATIONS,
    FEATURE_LEN,
    NUM_OF_MIXTURE,
    PCA_LEN_TEST,
    PCA_LEN_TRAIN,
    THRESHOLD_OF_DISTANCE,
)
from jeicyboodsp_tpu.utils.cnum import REF_PI

# float32 dots stay float32 on the GPU (its default f32 dot is TF32)
_HI = jax.lax.Precision.HIGHEST
_mm = functools.partial(jnp.matmul, precision=_HI)


def _top_eigpairs(cov, k):
    vals, vecs = jnp.linalg.eigh(cov)
    order = jnp.argsort(-vals, stable=True)[:k]
    return vals[order], vecs[:, order]


def _pca_prob(frames, mean, cov, n_keep):
    """Batched probability(): top-n_keep PCA-projected diagonal product.

    frames: (N, 12); returns (N,) densities.
    """
    vals, vecs = _top_eigpairs(cov, n_keep)
    xp = _mm(frames, vecs)  # (N, k)
    mp = _mm(mean, vecs)
    terms = (1.0 / jnp.sqrt(2.0 * REF_PI)) * (1.0 / jnp.sqrt(vals)) * jnp.exp(
        -0.5 * (xp - mp[None, :]) ** 2 / vals
    )
    return jnp.prod(terms, axis=1)


@functools.partial(jax.jit, static_argnames=())
def kmeans(frames, mask, init_means):
    """Compat K-means with the accumulating Selection quirk.

    frames: (N, 12) f64, mask: (N,) bool valid-frame mask.
    Returns (means (4,12), covs (4,12,12)).
    """
    N = frames.shape[0]

    def dist(means):
        return jnp.sum((frames[:, None, :] - means[None, :, :]) ** 2, axis=2)

    def assign(sel, means):
        d = dist(means)
        # ties -> last index (reference scans with >=)
        arg = (NUM_OF_MIXTURE - 1) - jnp.argmin(d[:, ::-1], axis=1)
        sel = sel | (jax.nn.one_hot(arg, NUM_OF_MIXTURE, dtype=bool) & mask[:, None])
        cost = jnp.sum(jnp.where(sel, d, 0.0))
        return sel, cost

    def cond(carry):
        count, converged, *_ = carry
        return ~converged

    def body(carry):
        count, _, sel, means, cost_before = carry
        sel, cost = assign(sel, means)
        count = count + 1
        keep_going = (count == 1) | (jnp.abs(cost - cost_before) >= THRESHOLD_OF_DISTANCE)
        # mean update (only when continuing; on convergence means stay)
        cnt = jnp.sum(sel, axis=0).astype(frames.dtype)
        sums = _mm(sel.astype(frames.dtype).T, frames)
        new_means = jnp.where(cnt[:, None] > 0, sums / jnp.maximum(cnt, 1.0)[:, None], 0.0)
        means_next = jnp.where(keep_going, new_means, means)
        return (count, ~keep_going, sel, means_next, jnp.where(keep_going, cost, cost_before))

    count0 = jnp.zeros((), jnp.int32)
    sel0 = jnp.zeros((N, NUM_OF_MIXTURE), bool)
    carry = (count0, jnp.zeros((), bool), sel0, init_means, jnp.zeros((), frames.dtype))
    count, _, sel, means, _ = jax.lax.while_loop(cond, body, carry)

    # final covariances over the accumulated labels with the final means
    cnt = jnp.sum(sel, axis=0).astype(frames.dtype)
    diff = frames[:, None, :] - means[None, :, :]  # (N, 4, 12)
    w = sel.astype(frames.dtype)
    covs = jnp.einsum("nk,nki,nkj->kij", w, diff, diff, precision=_HI) / cnt[:, None, None]
    return means, covs


def em_step(frames, mask, alpha, mean, cov):
    """One compat EM iteration (non-reset alpha/mean accumulators)."""
    n = jnp.sum(mask).astype(frames.dtype)
    probs = jnp.stack(
        [_pca_prob(frames, mean[k], cov[k], PCA_LEN_TRAIN) for k in range(NUM_OF_MIXTURE)],
        axis=1,
    )  # (N, 4)
    w = probs * alpha[None, :]
    w = w / jnp.sum(w, axis=1, keepdims=True)
    w = jnp.where(mask[:, None], w, 0.0)

    n_of_key = alpha + jnp.sum(w, axis=0)
    alpha_new = n_of_key / n
    mean_new = (mean + _mm(w.T, frames)) / n_of_key[:, None]
    diff = frames[:, None, :] - mean_new[None, :, :]
    cov_new = jnp.einsum("nk,nki,nkj->kij", w, diff, diff, precision=_HI) / n_of_key[:, None, None]
    return alpha_new, mean_new, cov_new


@jax.jit
def em_loglik_compat(frames, alpha, mean, cov):
    """The reference's post-M-step likelihood diagnostic, quirks included
    (``GMMAlgorithm_Train_Auto_ver2.cpp:326-332``): dTemp2 is never reset
    inside the frame loop, so each frame's log() sees the RUNNING CUMULATIVE
    sum of per-frame mixture likelihoods -- sum_i log(cumsum_i(sum_k alpha_k
    p_k(x_i))).  Printed by the CLI's --verbose as ' before X after Y'."""
    p = sum(
        alpha[k] * _pca_prob(frames, mean[k], cov[k], PCA_LEN_TRAIN)
        for k in range(NUM_OF_MIXTURE)
    )
    return jnp.sum(jnp.log(jnp.cumsum(p)))


@functools.partial(jax.jit, static_argnames=("iterations", "cov_floor"))
def train_single_file(frames, mask, iterations=EM_ITERATIONS, cov_floor: float = 0.0):
    """Seed + K-means + EM on one feature array (first file of a class).

    cov_floor=0.0 is the reference behavior.  A small positive floor
    (added as eps*I after k-means and each EM step) regularizes the
    rank-deficient covariances that arise when a mixture owns fewer
    frames than dimensions -- needed by the HMM trainer's tiny per-state
    fits, NOT by the reference's corpus-size classes."""
    init_means = frames[jnp.arange(NUM_OF_MIXTURE) * 4]
    mean, cov = kmeans(frames, mask, init_means)
    eye = jnp.eye(frames.shape[1], dtype=frames.dtype)
    if cov_floor:
        cov = cov + cov_floor * eye
    alpha = jnp.full((NUM_OF_MIXTURE,), 1.0 / NUM_OF_MIXTURE, frames.dtype)

    def body(_, carry):
        a, m, c = carry
        a, m, c = em_step(frames, mask, a, m, c)
        if cov_floor:
            c = c + cov_floor * eye
        return a, m, c

    alpha, mean, cov = jax.lax.fori_loop(0, iterations, body, (alpha, mean, cov))
    return alpha, mean, cov


@jax.jit
def em_file(frames, mask, alpha, mean, cov):
    """EM_ITERATIONS more iterations on a subsequent file of the class."""

    def body(_, carry):
        a, m, c = carry
        return em_step(frames, mask, a, m, c)

    return jax.lax.fori_loop(0, EM_ITERATIONS, body, (alpha, mean, cov))


@jax.jit
def pca_export(alpha, mean, cov):
    """Top-8 PCA export with the stale-covariance-rows quirk.

    Returns (alpha, mean_out (4,12), cov_out (4,12,12), eigvec (4,12,8)).
    """

    def one(mean_k, cov_k):
        vals, vecs = _top_eigpairs(cov_k, PCA_LEN_TRAIN)
        proj = _mm(mean_k, vecs)
        mean_out = jnp.zeros((FEATURE_LEN,), mean_k.dtype).at[:PCA_LEN_TRAIN].set(proj)
        cov_out = cov_k
        for i in range(PCA_LEN_TRAIN):
            cov_out = cov_out.at[i].set(0.0).at[i, i].set(vals[i])
        return mean_out, cov_out, vecs

    mean_out, cov_out, eigvec = jax.vmap(one)(mean, cov)
    return alpha, mean_out, cov_out, eigvec


@jax.jit
def score_frames(frames, alpha, mean, cov, eigvec):
    """Classifier scorer (PCA_LEN=4): length-normalized total log likelihood.

    frames: (N, 12); model arrays as stored (test layout: eigvec (4, 12, 4),
    cov diagonal in the top-left 4x4 block).
    Matches oracle.gmm.score_file.
    """

    def mixture(k):
        xp = _mm(frames, eigvec[k][:, :PCA_LEN_TEST])  # (N, 4)
        var = jnp.diagonal(cov[k])[:PCA_LEN_TEST]
        terms = (1.0 / jnp.sqrt(2.0 * REF_PI)) * (1.0 / jnp.sqrt(var)) * jnp.exp(
            -0.5 * (xp - mean[k][:PCA_LEN_TEST]) ** 2 / var
        )
        return alpha[k] * jnp.prod(terms, axis=1)

    s = sum(mixture(k) for k in range(NUM_OF_MIXTURE))
    return jnp.mean(jnp.log(s))


@functools.partial(jax.jit, static_argnames=("iterations", "cov_floor"))
def train_classes_batched(frames, masks, iterations=EM_ITERATIONS, cov_floor: float = 0.0):
    """vmapped per-class training: frames (C, N, 12) padded, masks (C, N).

    The class axis is the framework's "expert" axis -- shard it over the
    data mesh dimension and each device trains its classes independently
    (no cross-class communication exists in the reference algorithm).
    Returns PCA-exported (alpha (C,4), mean (C,4,12), cov (C,4,12,12),
    eigvec (C,4,12,8)).
    """

    def one(f, m):
        alpha, mean, cov = train_single_file(f, m, iterations=iterations, cov_floor=cov_floor)
        return pca_export(alpha, mean, cov)

    return jax.vmap(one)(frames, masks)


@jax.jit
def score_frames_all_classes(frames, alphas, means, covs, eigvecs):
    """Score one utterance against ALL classes at once.

    frames (N, 12); model arrays stacked over classes (C, ...).  Returns
    (C,) length-normalized log likelihoods -- argmax is the prediction.
    """
    return jax.vmap(lambda a, m, c, e: score_frames(frames, a, m, c, e))(
        alphas, means, covs, eigvecs
    )


def _em_iterations_verbose(frames, mask, alpha, mean, cov):
    """EM_ITERATIONS steps with the reference's per-iteration diagnostics
    (``GMMAlgorithm_Train_Auto_ver2.cpp:268,332,339``): 'count_ %d', then
    ' before %.5f after %.5f' with the quirky cumulative likelihood
    (:func:`em_loglik_compat`), then 'training end!'.  dTempBf starts at 0
    for every EM call (it is a local)."""
    import sys

    bf = 0.0
    for it in range(1, EM_ITERATIONS + 1):
        sys.stdout.write("count_ %d \n" % it)
        alpha, mean, cov = em_step(frames, mask, alpha, mean, cov)
        aft = float(em_loglik_compat(frames, alpha, mean, cov))
        sys.stdout.write(" before %.5f after %.5f \n" % (bf, aft))
        bf = aft
    sys.stdout.write("training end! \n")
    return alpha, mean, cov


def train_class(files: list[np.ndarray], dtype=jnp.float64, verbose: bool = False):
    """Host-level per-class training over a list of feature arrays,
    mirroring the reference's file loop.  Returns PCA-exported params.
    ``verbose`` emits the reference's per-EM-iteration likelihood prints."""
    f0 = jnp.asarray(files[0], dtype)
    mask0 = jnp.ones(len(files[0]), bool)
    if verbose:
        init_means = f0[jnp.arange(NUM_OF_MIXTURE) * 4]
        mean, cov = kmeans(f0, mask0, init_means)
        alpha = jnp.full((NUM_OF_MIXTURE,), 1.0 / NUM_OF_MIXTURE, dtype)
        alpha, mean, cov = _em_iterations_verbose(f0, mask0, alpha, mean, cov)
    else:
        alpha, mean, cov = train_single_file(f0, mask0)
    # reference runs EM again on file 1? No: the first file's EM already ran
    # inside the iInitCount==1 branch followed by the shared EM call -- i.e.
    # file 1 gets K-means + 3 EM iterations, each later file 3 more.
    for frames in files[1:]:
        fa = jnp.asarray(frames, dtype)
        m = jnp.ones(len(frames), bool)
        if verbose:
            alpha, mean, cov = _em_iterations_verbose(fa, m, alpha, mean, cov)
        else:
            alpha, mean, cov = em_file(fa, m, alpha, mean, cov)
    return pca_export(alpha, mean, cov)

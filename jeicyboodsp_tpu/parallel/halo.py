"""Halo exchange + sharded associative scans over a time-sharded axis.

These are the framework's two communication primitives (SURVEY §5
"long-context / sequence parallelism"):

- :func:`left_halo` -- the DSP analog of ring-attention neighbor exchange:
  each shard receives the trailing ``width`` elements of its LEFT neighbor
  (the overlap-save / STFT history), via ``jax.lax.ppermute``.

- :func:`sharded_associative_scan` -- an exact inclusive scan of a monoid
  over the time axis when the data is block-sharded: local
  ``associative_scan``, one small ``all_gather`` of per-shard aggregates,
  an exclusive cross-shard prefix folded locally, then one combine.  Used
  for the enhancement chain's noise-latch state and the MVDR covariance
  prefix, making those pipelines time-shardable without serializing.

All functions here are written to run INSIDE ``jax.shard_map``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def left_halo(x, width: int, axis_name: str, fill=0):
    """Return the `width` rows immediately preceding this shard's rows.

    x: (T_loc, ...) local shard of a block-sharded global array.  When the
    halo is wider than one shard (e.g. the 7-block overlap-save history on
    small shards), rows are collected from ceil(width / T_loc) left
    neighbors with one ppermute per hop.  Out-of-range rows (before the
    global start) are `fill`.
    """
    t_loc = x.shape[0]
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    hops = -(-width // t_loc)  # ceil
    parts = []
    for h in range(hops, 0, -1):
        perm = [(i, i + h) for i in range(n - h)]
        received = jax.lax.ppermute(x, axis_name, perm) if perm else jnp.zeros_like(x)
        received = jnp.where(idx >= h, received, jnp.full_like(received, fill))
        parts.append(received)
    ext = jnp.concatenate(parts, axis=0)  # rows [i-hops*T .. i*T)
    return ext[-width:]


def sharded_associative_scan(combine, elems, axis_name: str, identity, varying_axes=None):
    """Exact inclusive scan over a block-sharded leading axis.

    combine: monoid combine over pytrees with leading (batch) axis -- the
      same callable usable with jax.lax.associative_scan;
    elems: pytree of (T_loc, ...) local elements;
    identity: pytree of unbatched identity elements.

    Returns (inclusive (T_loc, ...), shard_exclusive_prefix (1, ...)): the
    prefix is the composed state of everything before this shard's first
    element (the identity on shard 0).
    """
    local = jax.lax.associative_scan(combine, elems)
    total = jax.tree_util.tree_map(lambda a: a[-1:], local)
    gathered = jax.lax.all_gather(total, axis_name)  # (S, 1, ...)
    gathered = jax.tree_util.tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), gathered)

    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    vaxes = tuple(varying_axes) if varying_axes is not None else (axis_name,)
    mark_varying = lambda a: jax.lax.pcast(jnp.asarray(a)[None], vaxes, to="varying")
    ident = jax.tree_util.tree_map(mark_varying, identity)

    def fold(i, acc):
        elem_i = jax.tree_util.tree_map(lambda a: a[i][None], gathered)
        new = combine(acc, elem_i)
        return jax.tree_util.tree_map(
            lambda o, nw: jnp.where(i < idx, nw, o), acc, new
        )

    prefix = jax.lax.fori_loop(0, n, fold, ident)  # exclusive prefix, (1, ...)
    prefix_b = jax.tree_util.tree_map(
        lambda p, l: jnp.repeat(p, l.shape[0], axis=0), prefix, local
    )
    return combine(prefix_b, local), prefix

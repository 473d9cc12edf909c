"""Time-sharded versions of the streaming pipelines (shard_map over a Mesh).

Each pipeline's sequential state was reformulated in ``ops`` as bounded
halos + associative prefixes, so the sharded versions are exact (bit-equal
to single-device in f64, asserted by tests/test_sharded.py):

- enhancement chain: 2-block x-halo (ppermute) + sharded noise-latch scan
  (all_gather of tiny per-shard aggregates) + a 1-frame leading recompute
  for the overlap-add tail;
- fast convolution: 7-block x-halo, everything else embarrassingly parallel;
- MVDR: 1-block x-halo + sharded prefix-SUM of the 2x2 covariance.

Data-parallel batching (independent streams) needs no shard_map at all --
``pjit`` with a NamedSharding on the batch axis partitions the vmapped ops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from jeicyboodsp_tpu.ops import enhance as E
from jeicyboodsp_tpu.ops import fastconv as FC
from jeicyboodsp_tpu.ops import mvdr as MV
from jeicyboodsp_tpu.parallel.halo import left_halo, sharded_associative_scan
from jeicyboodsp_tpu.utils.cnum import c_short_jnp

# float32 dots stay float32 on the GPU (its default f32 dot is TF32)
_HI = jax.lax.Precision.HIGHEST
_mm = functools.partial(jnp.matmul, precision=_HI)


def enhance_sharded(blocks, mesh, mode: str = "wiener", dtype=jnp.float64, axis: str = "time"):
    """(T, 512) int16 (T divisible by mesh axis size) -> (out, write_mask).

    Exact equal to ops.enhance.enhance_blocks.
    """
    n_shards = mesh.shape[axis]
    T = blocks.shape[0]
    assert T % n_shards == 0, (T, n_shards)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=(P(axis, None), P(axis)),
    )
    def run(local):
        Tl = local.shape[0]
        idx = jax.lax.axis_index(axis)
        t0 = idx * Tl
        gidx = t0 + jnp.arange(Tl)

        halo2 = left_halo(local, 2, axis)  # (2, 512): x[t0-2], x[t0-1]
        ext = jnp.concatenate([halo2, local], axis=0)  # (Tl+2, 512)

        # frames for local blocks: [x[t-1], x[t]]
        frames = jnp.concatenate([ext[1:-1], ext[2:]], axis=1)
        X = E.frame_transform(frames, dtype)
        mags = jnp.abs(X)
        speech = E.vad_flags(local, dtype)
        noise = ~speech

        # global run-length scan
        (cnt, _), (pc, pf) = sharded_associative_scan(
            E.runlen_combine,
            (noise.astype(jnp.int32), noise),
            axis,
            (jnp.zeros((), jnp.int32), jnp.ones((), bool)),
        )

        # global noise-affine scan
        elems = E.noise_affine_elements(speech, cnt, mags)
        ident = (
            jnp.ones((), dtype),
            jnp.zeros((E.FFT_SIZE,), dtype),
            jnp.zeros((), bool),
            jnp.zeros((), dtype),
            jnp.zeros((E.FFT_SIZE,), dtype),
        )
        (a_, b_, s_, ah_, bh_), (pa, pb, ps, pah, pbh) = sharded_associative_scan(
            E.noise_affine_combine, elems, axis, ident
        )
        ns = E.latched_from_composed(s_, bh_)  # (Tl, 1024)

        y = E.gain_and_resynth(X, ns, mode)  # (Tl, 1024)

        # leading frame (global t0-1) for the first local block's OLA tail
        lead_frame = jnp.concatenate([ext[0], ext[1]])[None, :]
        X_lead = E.frame_transform(lead_frame, dtype)
        ns_lead = E.latched_from_composed(ps, pbh)  # shard-prefix state
        y_lead = E.gain_and_resynth(X_lead, ns_lead, mode)  # (1, 1024)

        head = y[:, : E.BLOCK_LEN]
        tails = jnp.concatenate([y_lead[:, E.BLOCK_LEN :], y[:-1, E.BLOCK_LEN :]], axis=0)
        valid = gidx >= 1
        use_tail = gidx >= 2
        ola = jnp.where(
            valid[:, None],
            head + jnp.where(use_tail[:, None], tails, 0.0),
            0.0,
        )
        out = jnp.where(use_tail[:, None], c_short_jnp(ola), 0)
        return out, use_tail

    return run(blocks)


def enhance_sharded2d(
    blocks,
    mesh,
    mode: str = "wiener",
    dtype=jnp.float32,
    batch_axis: str = "data",
    time_axis: str = "time",
):
    """(B, T, 512) int16 over a 2-D (data x time) mesh -> (out, write_mask).

    The production serving form: independent streams shard over the data
    axis (no communication), each stream's time axis shards as in
    :func:`enhance_sharded` (ppermute halos + prefix scans over `time_axis`).
    Exactly equals per-stream enhance_blocks (tests).
    """
    Bn, T = blocks.shape[0], blocks.shape[1]
    assert Bn % mesh.shape[batch_axis] == 0 and T % mesh.shape[time_axis] == 0

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(batch_axis, time_axis, None),
        out_specs=(P(batch_axis, time_axis, None), P(batch_axis, time_axis)),
    )
    def run(local):  # (B_loc, Tl, 512)
        local = jnp.swapaxes(local, 0, 1)  # (Tl, B_loc, 512): time leads
        Tl = local.shape[0]
        idx = jax.lax.axis_index(time_axis)
        gidx = idx * Tl + jnp.arange(Tl)

        halo2 = left_halo(local, 2, time_axis)  # (2, B_loc, 512)
        ext = jnp.concatenate([halo2, local], axis=0)

        frames = jnp.concatenate([ext[1:-1], ext[2:]], axis=-1)  # (Tl, B, 1024)
        X = E.frame_transform(frames, dtype)
        mags = jnp.abs(X)
        speech = E.vad_flags(local, dtype)  # (Tl, B)
        noise = ~speech

        (cnt, _), _ = sharded_associative_scan(
            E.runlen_combine,
            (noise.astype(jnp.int32), noise),
            time_axis,
            (jnp.zeros(noise.shape[1:], jnp.int32), jnp.ones(noise.shape[1:], bool)),
            varying_axes=(batch_axis, time_axis),
        )
        elems = E.noise_affine_elements(speech, cnt, mags)
        nb = mags.shape[-1]
        Bl = noise.shape[1]
        ident = (
            jnp.ones((Bl,), dtype),
            jnp.zeros((Bl, nb), dtype),
            jnp.zeros((Bl,), bool),
            jnp.zeros((Bl,), dtype),
            jnp.zeros((Bl, nb), dtype),
        )
        (a_, b_, s_, ah_, bh_), (pa, pb, ps, pah, pbh) = sharded_associative_scan(
            E.noise_affine_combine, elems, time_axis, ident,
            varying_axes=(batch_axis, time_axis),
        )
        ns = E.latched_from_composed(s_, bh_)
        y = E.gain_and_resynth(X, ns, mode)

        lead_frame = jnp.concatenate([ext[0], ext[1]], axis=-1)[None]  # (1, B, 1024)
        X_lead = E.frame_transform(lead_frame, dtype)
        ns_lead = E.latched_from_composed(ps, pbh)
        y_lead = E.gain_and_resynth(X_lead, ns_lead, mode)

        head = y[..., : E.BLOCK_LEN]
        tails = jnp.concatenate([y_lead[..., E.BLOCK_LEN :], y[:-1, :, E.BLOCK_LEN :]], axis=0)
        valid = (gidx >= 1)[:, None, None]
        use_tail = (gidx >= 2)[:, None, None]
        ola = jnp.where(valid, head + jnp.where(use_tail, tails, 0.0), 0.0)
        out = jnp.where(use_tail, c_short_jnp(ola), 0)
        mask = jnp.broadcast_to((gidx >= 2)[:, None], (Tl, Bl))
        return jnp.swapaxes(out, 0, 1), jnp.swapaxes(mask, 0, 1)

    return run(blocks)


def fastconv_sharded(blocks, Hr, Hi, mesh, dtype=jnp.float64, axis: str = "time"):
    """(T, 1024) int16 -> (T, 1024) int16 out + mask (t >= 7).

    Unlike ops.fastconv (which drops warm-up rows), returns full T rows with
    a validity mask so the sharding stays uniform.
    """
    n_shards = mesh.shape[axis]
    T = blocks.shape[0]
    assert T % n_shards == 0

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=P(axis, None), out_specs=(P(axis, None), P(axis))
    )
    def run(local):
        Tl = local.shape[0]
        idx = jax.lax.axis_index(axis)
        gidx = idx * Tl + jnp.arange(Tl)
        # zero the warm-up blocks (global t < 7) before they enter any segment
        local_eff = jnp.where((gidx >= FC.WARMUP_BLOCKS)[:, None], local, 0)
        halo = left_halo(local_eff, FC.WARMUP_BLOCKS, axis)  # (7, 1024)
        ext = jnp.concatenate([halo, local_eff], axis=0).astype(dtype)  # (Tl+7, 1024)
        # segments from static slices (segment t = blocks t..t+7), no gather
        segs = jnp.concatenate(
            [ext[i : i + Tl] for i in range(FC.WARMUP_BLOCKS + 1)], axis=1
        )
        ctype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
        y = jnp.fft.ifft(jnp.fft.fft(segs.astype(ctype)) * (Hr + 1j * Hi).astype(ctype)).real
        out = c_short_jnp(y[:, FC.FILTER_LENGTH - 1 :])
        mask = gidx >= FC.WARMUP_BLOCKS
        return jnp.where(mask[:, None], out, 0), mask

    return run(blocks)


def bnlms_sharded(x_blocks, ref_blocks, mesh, dtype=jnp.float64, axis: str = "data"):
    """Stream-data-parallel BNLMS: (B, T, 1024) far/near blocks, B streams
    sharded over ``axis``.  Each AEC session is an independent recursion
    (BNLMS.cpp:103-162 keeps per-session statics), so the natural multi-chip
    axis is sessions: shard_map runs the per-device vmap'd block scan with
    zero collectives -- only inputs and outputs move between devices.
    Exact equal to vmapped ops.nlms.bnlms_apply (asserted in
    tests/test_sharded.py).  Returns (est, err) as (B, T, 1024) int16."""
    from jeicyboodsp_tpu.ops import nlms as NL

    B = x_blocks.shape[0]
    assert B % mesh.shape[axis] == 0, (B, mesh.shape)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
    )
    def run(xl, rl):
        st = jax.vmap(lambda _: NL.bnlms_init_state(dtype))(jnp.arange(xl.shape[0]))
        # the zero init state is device-invariant; mark it varying over the
        # mesh axis so the scan carry types match (shard_map vma rules)
        st = jax.tree.map(lambda a: jax.lax.pcast(a, (axis,), to="varying"), st)
        est, err, _ = jax.vmap(
            functools.partial(NL.bnlms_apply, dtype=dtype)
        )(xl, rl, st)
        return est, err

    return run(x_blocks, ref_blocks)


def bnlms_sharded_time(x_blocks, ref_blocks, mesh, dtype=jnp.float32,
                       axis: str = "time"):
    """TIME-sharded BNLMS: ONE AEC session's (T, 1024) blocks sharded over
    ``axis`` (VERDICT r4 missing-item 3: the block-parallel formulation
    SURVEY §5 called the natural one).

    Rests on ops.nlms.bnlms_affine_elements: the per-block coefficient
    update is affine in c once the estimate truncation is linearized out
    of the recursion, so the c-sequence is an associative scan of
    (A, v) pairs -- locally O(log T_loc), across shards one small
    all_gather of per-shard composed maps (sharded_associative_scan).
    The input halo is ONE block via ppermute (the Toeplitz keep + the
    double-talk gate's history both derive from it).  Exact equal to the
    unsharded bnlms_apply_timeparallel up to f32 reduction order
    (asserted in tests/test_sharded.py).  Returns (est, err) int16.
    """
    from jeicyboodsp_tpu.ops import nlms as NL

    T = x_blocks.shape[0]
    assert T % mesh.shape[axis] == 0, (T, mesh.shape)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(axis, None), P(axis, None)),
        out_specs=(P(axis, None), P(axis, None)),
    )
    def run(xl, rl):
        prev_x = left_halo(xl, 1, axis)[0]  # previous block (zeros on shard 0)
        prev_r = left_halo(rl, 1, axis)[0]
        A, v, W, _ = NL.bnlms_affine_elements(
            xl, rl, dtype=dtype, keep_in=prev_x, keep_ref=prev_r
        )
        ident = (jnp.eye(NL.BNLMS_TAPS, dtype=dtype), jnp.zeros(NL.BNLMS_TAPS, dtype))
        (A_incl, v_incl), _ = sharded_associative_scan(
            NL.affine_combine, (A, v), axis, ident
        )
        # c before block b = exclusive prefix: shift the INCLUSIVE scan by
        # one row ACROSS shards (another 1-row ppermute halo)
        prev_v = left_halo(v_incl, 1, axis, fill=0)[0]
        c = jnp.concatenate([prev_v[None], v_incl[:-1]], axis=0)
        y = jnp.einsum("bti,bi->bt", W[:, :, ::-1], c,
                       precision=jax.lax.Precision.HIGHEST)
        y_s = c_short_jnp(y)
        e = rl.astype(jnp.int32) - y_s.astype(jnp.int32)
        return y_s.astype(jnp.int16), c_short_jnp(e.astype(dtype)).astype(jnp.int16)

    return run(x_blocks, ref_blocks)


def nlms_sharded(x, ref, mesh, dtype=jnp.float64, axis: str = "data",
                 compat: bool = True):
    """Stream-data-parallel per-sample NLMS: (B, N) int16 far/near signals.

    Same sharding story as :func:`bnlms_sharded` (independent sessions,
    NormalLMS.cpp:96-130); the per-device work is the vmapped sample scan.
    Returns (est, err) as (B, N) int16."""
    from jeicyboodsp_tpu.ops import nlms as NL

    B = x.shape[0]
    assert B % mesh.shape[axis] == 0, (B, mesh.shape)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
    )
    def run(xl, rl):
        st = jax.vmap(lambda _: NL.nlms_init_state(dtype))(jnp.arange(xl.shape[0]))
        st = jax.tree.map(lambda a: jax.lax.pcast(a, (axis,), to="varying"), st)
        est, err, _ = jax.vmap(
            functools.partial(NL.nlms_apply, dtype=dtype, compat=compat)
        )(xl, rl, st)
        return est, err

    return run(x, ref)


def mvdr_sharded(blocks_l, blocks_r, mesh, d_time=0.0, dtype=jnp.float64, axis: str = "time"):
    """Time-sharded MVDR; exact equal to ops.mvdr.mvdr_blocks."""
    n_shards = mesh.shape[axis]
    T = blocks_l.shape[0]
    assert T % n_shards == 0

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=(P(axis, None), P(axis)),
    )
    def run(local_l, local_r):
        Tl = local_l.shape[0]
        idx = jax.lax.axis_index(axis)
        gidx = idx * Tl + jnp.arange(Tl)
        ctype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64

        halo_l = left_halo(local_l, 1, axis)
        halo_r = left_halo(local_r, 1, axis)
        prev_l = jnp.concatenate([halo_l, local_l[:-1]], axis=0)
        prev_r = jnp.concatenate([halo_r, local_r[:-1]], axis=0)

        speech = MV.vad_energy_flags(local_l, dtype)
        noise = ~speech
        (cnt, _), _ = sharded_associative_scan(
            E.runlen_combine,
            (noise.astype(jnp.int32), noise),
            axis,
            (jnp.zeros((), jnp.int32), jnp.ones((), bool)),
        )
        accumulate = noise & (cnt >= 2)

        pairs_l = jnp.concatenate([prev_l, local_l], axis=1).astype(dtype)
        pairs_r = jnp.concatenate([prev_r, local_r], axis=1).astype(dtype)
        Lf = jnp.fft.fft(pairs_l.astype(ctype))
        Rf = jnp.fft.fft(pairs_r.astype(ctype))
        r00 = jnp.sum(Lf.real ** 2 + Lf.imag ** 2, axis=1) / MV.FFT_LEN
        r01 = jnp.sum(-Lf.real * Rf.imag + Lf.imag * Rf.real, axis=1) / MV.FFT_LEN
        r10 = jnp.sum(-Rf.real * Lf.imag + Rf.imag * Lf.real, axis=1) / MV.FFT_LEN
        r11 = jnp.sum(Rf.real ** 2 + Rf.imag ** 2, axis=1) / MV.FFT_LEN
        contrib = jnp.stack([r00, r01, r10, r11], axis=1) * accumulate[:, None].astype(dtype)

        def addc(l, r):
            return (l[0] + r[0],)

        (R,), _ = sharded_associative_scan(
            addc, (contrib,), axis, (jnp.zeros((4,), dtype),)
        )

        a, b, c_, d = R[:, 0], R[:, 1], R[:, 2], R[:, 3]
        det = a * d - b * c_
        inv = jnp.stack([d, -b, -c_, a], axis=1) / det[:, None]

        i = jnp.arange(MV.FFT_LEN, dtype=dtype)
        from jeicyboodsp_tpu.utils.cnum import REF_PI

        ang = 2.0 * REF_PI * i * (MV.SAMPLING_RATE / MV.FFT_LEN) * d_time
        c0 = jnp.ones((MV.FFT_LEN,), ctype)
        c1 = (jnp.cos(ang) + 1j * jnp.sin(ang)).astype(ctype)
        w0 = inv[:, 0, None] * c0[None, :] + inv[:, 1, None] * c1[None, :]
        w1 = inv[:, 2, None] * c0[None, :] + inv[:, 3, None] * c1[None, :]
        denom = jnp.conj(c0)[None, :] * w0 + jnp.conj(c1)[None, :] * w1
        w0 = w0 / denom
        w1 = w1 / denom

        zero_tail = jnp.zeros((Tl, 1), dtype)
        frame_l = jnp.concatenate(
            [prev_l[:, : MV.KEEP_LEN].astype(dtype), local_l.astype(dtype), zero_tail], axis=1
        )
        frame_r = jnp.concatenate(
            [prev_r[:, : MV.KEEP_LEN].astype(dtype), local_r.astype(dtype), zero_tail], axis=1
        )
        L = jnp.fft.fft(frame_l.astype(ctype))
        Rch = jnp.fft.fft(frame_r.astype(ctype))
        wl_r, wl_i = w0.real, -w0.imag
        wr_r, wr_i = w1.real, -w1.imag
        L0 = L.real * wl_r - L.imag * wl_i
        L1 = L0 * wl_i + L.imag * wl_r
        R0 = Rch.real * wr_r - Rch.imag * wr_i
        R1 = R0 * wr_i + Rch.imag * wr_r
        merged = ((L0 + R0) + 1j * (L1 + R1)).astype(ctype)
        y = jnp.fft.ifft(merged).real
        out = c_short_jnp(y[:, MV.KEEP_LEN : MV.KEEP_LEN + MV.BLOCK_LEN])
        mask = gidx >= 1
        return out, mask

    return run(blocks_l, blocks_r)


def mvdr_sharded_bins(blocks_l, blocks_r, mesh, d_time=0.0, axis: str = "model"):
    """Frequency-bin tensor-parallel MVDR (the matmul-DFT formulation).

    With the DFT evaluated as matmuls (ops/dft.py), the frequency axis
    shards exactly like a transformer MLP's hidden axis:

    - forward DFT: COLUMN-parallel matmuls (each device computes its own
      bins from the replicated frames -- zero communication);
    - covariance: the per-block 2x2 R contribution is a sum over bins ->
      one ``psum`` (the all-reduce of the column-parallel stage);
    - per-bin steering / 2x2 solves / weight application: local;
    - inverse DFT: ROW-parallel matmuls (each device's bins contribute a
      partial time-domain signal) -> one ``psum``.

    Two all-reduces per call, everything else embarrassingly parallel over
    bins.  Matches ops.mvdr.mvdr_blocks(fft_engine="mxu") up to f32
    reduction-order rounding.  No reference counterpart (SURVEY §5): this is
    the framework's tensor-parallel axis, composable with the time/data axes.
    """
    from jeicyboodsp_tpu.ops import dft as mdft
    from jeicyboodsp_tpu.utils.cnum import REF_PI

    n = MV.FFT_LEN
    n_shards = mesh.shape[axis]
    assert n % n_shards == 0
    T = blocks_l.shape[0]
    dtype = jnp.float32

    # full-bin forward/inverse matrices (n, n) / (n, n), sharded on the bin axis
    Ch, Sh = mdft._rdft_mats(n)
    import numpy as np

    C = np.concatenate([Ch, Ch[:, -2:0:-1]], axis=1)  # cos even under k -> n-k
    S = np.concatenate([Sh, -Sh[:, -2:0:-1]], axis=1)
    IC, IS = mdft._icdft_real_mats(n)
    prec = jax.lax.Precision.HIGHEST

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(),  # blocks replicated
            P(None, axis), P(None, axis),  # forward mats: column-sharded
            P(axis, None), P(axis, None),  # inverse mats: row-sharded
            P(axis),  # bin indices
        ),
        out_specs=(P(), P()),
    )
    def run(bl, br, Cl, Sl, ICl, ISl, bins):
        speech = MV.vad_energy_flags(bl, dtype)
        noise = ~speech
        cnt, _ = jax.lax.associative_scan(
            E.runlen_combine, (noise.astype(jnp.int32), noise)
        )
        accumulate = noise & (cnt >= 2)

        prev_l = jnp.concatenate([jnp.zeros((1, MV.BLOCK_LEN), bl.dtype), bl[:-1]])
        prev_r = jnp.concatenate([jnp.zeros((1, MV.BLOCK_LEN), br.dtype), br[:-1]])
        pairs_l = jnp.concatenate([prev_l, bl], axis=1).astype(dtype)
        pairs_r = jnp.concatenate([prev_r, br], axis=1).astype(dtype)

        # column-parallel forward DFT: local bins only
        Lfr = jnp.dot(pairs_l, Cl, precision=prec)
        Lfi = jnp.dot(pairs_l, Sl, precision=prec)
        Rfr = jnp.dot(pairs_r, Cl, precision=prec)
        Rfi = jnp.dot(pairs_r, Sl, precision=prec)

        # R contribution: partial sum over local bins -> all-reduce
        r00 = jax.lax.psum(jnp.sum(Lfr**2 + Lfi**2, axis=1), axis) / n
        r01 = jax.lax.psum(jnp.sum(-Lfr * Rfi + Lfi * Rfr, axis=1), axis) / n
        r10 = jax.lax.psum(jnp.sum(-Rfr * Lfi + Rfi * Lfr, axis=1), axis) / n
        r11 = jax.lax.psum(jnp.sum(Rfr**2 + Rfi**2, axis=1), axis) / n
        contrib = jnp.stack([r00, r01, r10, r11], axis=1) * accumulate[:, None].astype(dtype)
        R = jnp.cumsum(contrib, axis=0)

        a, b, c_, d = R[:, 0], R[:, 1], R[:, 2], R[:, 3]
        det = a * d - b * c_
        inv = jnp.stack([d, -b, -c_, a], axis=1) / det[:, None]

        # steering for the LOCAL bins
        ang = 2.0 * REF_PI * bins.astype(dtype) * (MV.SAMPLING_RATE / n) * d_time
        c0r = jnp.ones_like(ang)
        c1r, c1i = jnp.cos(ang), jnp.sin(ang)
        w0r = inv[:, 0, None] * c0r[None, :] + inv[:, 1, None] * c1r[None, :]
        w0i = inv[:, 1, None] * c1i[None, :]
        w1r = inv[:, 2, None] * c0r[None, :] + inv[:, 3, None] * c1r[None, :]
        w1i = inv[:, 3, None] * c1i[None, :]
        # denom = c0* w0 + c1* w1 (complex); then w /= denom
        dr = c0r[None, :] * w0r + (c1r[None, :] * w1r + c1i[None, :] * w1i)
        di = c0r[None, :] * w0i + (c1r[None, :] * w1i - c1i[None, :] * w1r)
        dd = dr**2 + di**2
        w0r, w0i = (w0r * dr + w0i * di) / dd, (w0i * dr - w0r * di) / dd
        w1r, w1i = (w1r * dr + w1i * di) / dd, (w1i * dr - w1r * di) / dd

        zero_tail = jnp.zeros((bl.shape[0], 1), dtype)
        frame_l = jnp.concatenate(
            [prev_l[:, : MV.KEEP_LEN].astype(dtype), bl.astype(dtype), zero_tail], axis=1
        )
        frame_r = jnp.concatenate(
            [prev_r[:, : MV.KEEP_LEN].astype(dtype), br.astype(dtype), zero_tail], axis=1
        )
        Lr = jnp.dot(frame_l, Cl, precision=prec)
        Li = jnp.dot(frame_l, Sl, precision=prec)
        Rr = jnp.dot(frame_r, Cl, precision=prec)
        Ri = jnp.dot(frame_r, Sl, precision=prec)

        wl_r, wl_i = w0r, -w0i  # conjugated weights
        wr_r, wr_i = w1r, -w1i
        L0 = Lr * wl_r - Li * wl_i  # overwrite-sequencing quirk preserved
        L1 = L0 * wl_i + Li * wl_r
        R0 = Rr * wr_r - Ri * wr_i
        R1 = R0 * wr_i + Ri * wr_r

        # row-parallel inverse: partial time-domain contribution -> all-reduce
        y_part = jnp.dot(L0 + R0, ICl, precision=prec) - jnp.dot(
            L1 + R1, ISl, precision=prec
        )
        y = jax.lax.psum(y_part, axis)
        out = c_short_jnp(y[:, MV.KEEP_LEN : MV.KEEP_LEN + MV.BLOCK_LEN])
        mask = jnp.arange(bl.shape[0]) >= 1
        return out, mask

    return run(
        blocks_l,
        blocks_r,
        jnp.asarray(C),
        jnp.asarray(S),
        jnp.asarray(IC),
        jnp.asarray(IS),
        jnp.arange(n),
    )


def data_parallel_sharding(mesh, axis: str = "data"):
    """NamedSharding that splits a leading batch axis across the data axis."""
    return NamedSharding(mesh, P(axis))


def em_step_sharded(frames, mask, alpha, mean, cov, mesh, axis: str = "data"):
    """One compat EM iteration with frames sharded over `axis`.

    The E-step responsibilities are local; the M-step sufficient statistics
    (responsibility sums, weighted feature sums, weighted scatter matrices)
    are the reference algorithm's only global reductions -- here explicit
    ``psum`` across devices (SURVEY §5).  Exactly equals models.gmm.em_step up to
    summation order.
    """
    import jax.numpy as jnp

    from jeicyboodsp_tpu.models.gmm import NUM_OF_MIXTURE, PCA_LEN_TRAIN, _pca_prob

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(), P(None, None), P(None, None, None)),
        out_specs=(P(), P(None, None), P(None, None, None)),
    )
    def run(f_loc, m_loc, alpha_r, mean_r, cov_r):
        probs = jnp.stack(
            [_pca_prob(f_loc, mean_r[k], cov_r[k], PCA_LEN_TRAIN) for k in range(NUM_OF_MIXTURE)],
            axis=1,
        )
        w = probs * alpha_r[None, :]
        w = w / jnp.sum(w, axis=1, keepdims=True)
        w = jnp.where(m_loc[:, None], w, 0.0)

        n = jax.lax.psum(jnp.sum(m_loc.astype(f_loc.dtype)), axis)
        w_sum = jax.lax.psum(jnp.sum(w, axis=0), axis)  # (4,)
        wx = jax.lax.psum(_mm(w.T, f_loc), axis)  # (4, 12)

        n_of_key = alpha_r + w_sum
        alpha_new = n_of_key / n
        mean_new = (mean_r + wx) / n_of_key[:, None]
        diff = f_loc[:, None, :] - mean_new[None, :, :]
        scatter = jax.lax.psum(jnp.einsum("nk,nki,nkj->kij", w, diff, diff, precision=_HI), axis)
        cov_new = scatter / n_of_key[:, None, None]
        return alpha_new, mean_new, cov_new

    return run(frames, mask, alpha, mean, cov)


def geq_sharded(x, b, a, mesh, dtype=jnp.float64, axis: str = "time"):
    """Time-sharded fast-mode 7-band GEQ (SURVEY §5: "blocked biquad via
    state-space matrices" under sequence parallelism).

    The linear cascade (ops.geq.geq_apply_fast, the un-quantized counterpart
    of ``7Band_GEQ.cpp:261-289``'s carried-state recursion) is, per band, an
    affine 2x2 state-space recursion -- an associative monoid -- so the time
    axis shards exactly: each band runs a local associative scan, one
    all_gather of per-shard 2x2 aggregates composes the cross-shard prefix,
    and a 2-sample ppermute halo supplies the FIR taps at shard boundaries.

    x: (N,) samples, N divisible by the mesh axis size.  Exactly equals
    ``geq_apply_fast`` in f64 (f32 overflows at the 44 Hz shelf's near-unity
    pole on either path).
    """
    from jeicyboodsp_tpu.ops.geq import TOTAL_BANDS

    n_shards = mesh.shape[axis]
    assert x.shape[0] % n_shards == 0, (x.shape, n_shards)
    b = jnp.asarray(b, dtype)
    a = jnp.asarray(a, dtype)
    eye2 = jnp.eye(2, dtype=dtype)

    def combine(l, r):
        Al, bl = l
        Ar, br = r
        return _mm(Ar, Al), jnp.einsum("...ij,...j->...i", Ar, bl, precision=_HI) + br

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P(axis), out_specs=P(axis))
    def run(xl):
        y = xl.astype(dtype)
        for k in range(TOTAL_BANDS):
            halo = left_halo(y[:, None], 2, axis)[:, 0]  # y[t0-2], y[t0-1]
            y1 = jnp.concatenate([halo[1:], y[:-1]])
            y2 = jnp.concatenate([halo, y[:-2]])
            f = b[k, 0] * y + b[k, 1] * y1 + b[k, 2] * y2
            A = jnp.array([[-a[k, 1], -a[k, 2]], [1.0, 0.0]], dtype)
            As = jnp.broadcast_to(A, (y.shape[0], 2, 2))
            Bs = jnp.stack([f, jnp.zeros_like(f)], axis=-1)
            (_, s), _ = sharded_associative_scan(
                combine, (As, Bs), axis, (eye2, jnp.zeros((2,), dtype))
            )
            y = s[:, 0]
        return y

    return run(x)

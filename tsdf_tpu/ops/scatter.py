"""Scatter-add without XLA scatter: sorted-window one-hot matmuls.

The adjoint of every gather stencil in this framework (the trilinear
8-tap sample ref: src/RayCaster/GPURaycaster.cu:53-124, the marching-
cubes compaction writes ref: src/MarchingCubes/MarkAndSweepMC.cu:219-304)
is a scatter-add. This module computes one without a scatter operation
(the ``scatter_free`` arm of marching cubes and SceneFusion): a one-hot
matmul is an exact f32 row-scatter,

    patch[r, l] = sum_c M[c, r] * V[c, l],   M one-hot in r, V one-hot
                                             in l scaled by the value

so a batch of C contributions (linear index, value) lands in a dense
(RP, 128) patch with two compares and one matmul. The full algorithm:

  1. view the flat output as rows of 128 lanes; row = lin >> 7,
     lane = lin & 127;
  2. sort contributions by lin (XLA sort; skipped when the caller's
     stream is already sorted, e.g. cumsum-offset writes);
  3. walk the sorted stream with a window of K contributions: each
     iteration builds the one-hot pair for every contribution within RP
     rows of the window head, matmuls it into a patch, adds the patch
     into the output with dynamic_slice/dynamic_update_slice (in-place
     inside the XLA while loop), and advances the cursor by the number
     of contributions consumed — duplicates simply accumulate in the
     matmul, so no dedup pass is needed.

Everything is static-shaped; the only data-dependence is the while-loop
trip count (~C/K for surface-like index distributions). D payload
channels ride ONE matmul per window: the accumulator is laid out
channel-interleaved as (rows, D, 128) so the (K, RP) one-hot contracts
against a (K, D*128) value block and the whole (RP, D, 128) patch lands
in a single dynamic_update_slice — per-window op count is independent
of D (one dot_general, one slice pair), only the MAC count scales.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_LANE = 128
# fold taps whose row offsets lie within this many rows share one patch
_FOLD_SPAN = 8


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@partial(
    jax.jit,
    static_argnames=(
        "n", "window", "rows_per_patch", "is_sorted", "fold_offsets"
    ),
)
def scatter_add_flat(
    n: int,
    lin: jnp.ndarray,
    val: jnp.ndarray,
    window: int = 2048,
    rows_per_patch: int = 256,
    is_sorted: bool | str = False,
    fold_offsets: tuple[int, ...] | None = None,
) -> jnp.ndarray:
    """out = zeros(n); out[lin[c]] += val[..., c] for every c; returns out.

    Args:
      n: static output length.
      lin: (C,) int32 target indices. Entries outside [0, n) are dropped
        (the standard jit-friendly "mask by pointing off the end" idiom).
      val: (C,) or (D, C) f32 values — D payload channels scattered with
        the same indices (one one-hot build, D matmuls).
      window: contributions considered per loop step (static).
      rows_per_patch: dense rows materialised per step (static). Windows
        spanning more rows than this consume a prefix and the cursor
        advances — exactness never depends on the tuning values.
      is_sorted: False = sort here. True = HINT that lin is already
        non-decreasing: an O(C) monotonicity check falls back to the
        sort when the hint is wrong (leading/interspersed out-of-range
        sentinels break monotonicity after the tail remap). "trusted" =
        skip even the check: the caller GUARANTEES ascending in-range
        entries with out-of-range entries only as a suffix — anything
        after the first violation would be silently dropped. Use only
        where the stream is ascending by construction (the cube-corner
        update's compaction ids): the checked variant's lax.cond
        carries a (1+D)-operand sort branch.
      fold_offsets: G static non-negative index offsets. val must then
        be (G*Dout, C) and the result is (Dout, n) with
        ``out[:, lin[c] + fold_offsets[g]] += val[g*Dout:(g+1)*Dout, c]``
        — G offset stencil taps sharing one window walk, folded into a
        Dout-channel accumulator INSIDE the window matmuls: each tap's
        one-hot row mask is built directly at its shifted target
        (lin+off), taps are grouped by row reach (off >> 7), and each
        group lands as one (T*K, RPP) x (T*K, Dout*128) matmul + one
        patch update (the SceneFusion cube-corner update: 8 corners x 4
        channels fold into 4, cutting the accumulator from 32 to 4
        dense channels; entries whose lin+offset lands outside [0, n)
        are dropped). The in-matmul fold keeps the loop body the same
        shape as the no-fold path (compare + matmul + one slice/update
        per group).

    Returns:
      (n,) f32 or (D, n) f32 ((Dout, n) under ``fold_offsets``).
    """
    squeeze = val.ndim == 1
    vals = val[None, :] if squeeze else val
    D, C = vals.shape
    assert lin.shape == (C,), (lin.shape, vals.shape)
    if fold_offsets is not None:
        G = len(fold_offsets)
        assert D % G == 0, (D, G)
        assert all(o >= 0 for o in fold_offsets), fold_offsets
        Dout = D // G
        # static grouping: taps whose row offsets (off >> 7) lie within
        # _FOLD_SPAN rows share one patch (one matmul + one update); a
        # 2x2x2 voxel stencil groups into its two z-planes
        order = sorted(range(G), key=lambda g: fold_offsets[g] >> 7)
        groups: list[list] = []  # [q0, span, [tap indices]]
        for g in order:
            q = fold_offsets[g] >> 7
            if groups and q - groups[-1][0] <= _FOLD_SPAN:
                groups[-1][1] = q - groups[-1][0]
                groups[-1][2].append(g)
            else:
                groups.append([q, 0, [g]])
    else:
        G, Dout = 1, D

    K = int(window)
    RP = int(rows_per_patch)
    nr = max(_round_up(n, _LANE) // _LANE, RP)
    # folded taps can land up to max(offset) past lin: give the
    # accumulator pad rows so the rolled patch update never clips, and
    # trim them at the end (out-of-range taps are thereby dropped)
    pad_rows = (
        0
        if fold_offsets is None
        else (max(fold_offsets) >> 7) + 2
    )
    nrp = nr + pad_rows

    lin = jnp.asarray(lin, jnp.int32)
    vals = jnp.asarray(vals, jnp.float32)
    # invalid -> one past the last row block; sorts to the end, never
    # matches a patch row
    lin = jnp.where((lin < 0) | (lin >= n), nr * _LANE, lin)

    if is_sorted is False:
        lin, *vs = jax.lax.sort([lin] + list(vals), num_keys=1)
        vals = jnp.stack(vs)
    elif is_sorted == "trusted":
        pass  # caller guarantees monotone + suffix-only sentinels
    elif C > 1:
        # ``is_sorted`` is a HINT, not a trusted contract: out-of-range
        # entries remap to the tail sentinel above, which breaks
        # monotonicity when a caller passes leading/interspersed
        # sentinels (e.g. -1 for masked slots) — and the windowed walk
        # below treats the first sentinel as a stream TERMINATOR,
        # silently dropping everything after it. An O(C) monotonicity
        # check falls back to the sort when the hint is wrong, so the
        # documented "out-of-range entries are dropped" semantics hold
        # on every path.
        ok = jnp.all(lin[1:] >= lin[:-1])

        def _trust(args):
            return args

        def _sort(args):
            l, v = args
            l, *vs = jax.lax.sort([l] + list(v), num_keys=1)
            return l, jnp.stack(vs)

        lin, vals = jax.lax.cond(ok, _trust, _sort, (lin, vals))

    # pad so the cursor's dynamic window never reads out of bounds
    lin = jnp.concatenate([lin, jnp.full((K,), nr * _LANE, jnp.int32)])
    vals = jnp.pad(vals, ((0, 0), (0, K)))

    # channel-interleaved accumulator: one (RP, D, 128) patch per window
    out = jnp.zeros((nrp, Dout, _LANE), jnp.float32)
    r_iota = jax.lax.broadcasted_iota(jnp.int32, (K, RP), 1)
    l_iota = jax.lax.broadcasted_iota(jnp.int32, (K, _LANE), 1)
    if fold_offsets is not None:
        g_iota = {
            span: jax.lax.broadcasted_iota(
                jnp.int32, (K, RP + span + 2), 1
            )
            for span in {g[1] for g in groups}
        }

    def cond(state):
        c, _ = state
        # stop once the cursor reaches the invalid/padding tail
        return jax.lax.dynamic_slice(lin, (c,), (1,))[0] < nr * _LANE

    def body(state):
        c, out = state
        lw = jax.lax.dynamic_slice(lin, (c,), (K,))
        rows = lw >> 7
        r0 = jnp.minimum(rows[0], nr - RP)
        local = rows - r0
        in_patch = local < RP  # sorted => a prefix of the window
        count = jnp.sum(in_patch.astype(jnp.int32))
        vw = jax.lax.dynamic_slice(vals, (0, c), (D, K))  # (D, K)
        if fold_offsets is None:
            lanes = lw & (_LANE - 1)
            m = ((local[:, None] == r_iota) & in_patch[:, None]).astype(
                jnp.float32
            )  # (K, RP)
            lane_oh = (lanes[:, None] == l_iota).astype(
                jnp.float32
            )  # (K, 128)
            v_blk = (vw.T[:, :, None] * lane_oh[:, None, :]).reshape(
                K, D * _LANE
            )
            patch = jax.lax.dot_general(
                m,
                v_blk,
                (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ).reshape(RP, D, _LANE)
            blk = jax.lax.dynamic_slice(out, (r0, 0, 0), (RP, D, _LANE))
            out = jax.lax.dynamic_update_slice(
                out, blk + patch, (r0, 0, 0)
            )
            return c + count, out
        # in-matmul fold: each tap's one-hot row mask targets lin+off
        # directly; one (T*K, RPP) x (T*K, Dout*128) matmul and ONE
        # slice/update per row-reach group. Taps whose target crosses
        # past n land in the accumulator's pad rows and are trimmed
        # (windows are in-range here: the cursor stops at the sentinel
        # tail, and in_patch masks the window's own tail).
        for q0, span, taps in groups:
            RPP = RP + span + 2
            ms, vb = [], []
            for g in taps:
                t = lw + fold_offsets[g]
                loc_g = (t >> 7) - (r0 + q0)
                m_g = (
                    (loc_g[:, None] == g_iota[span])
                    & in_patch[:, None]
                ).astype(jnp.float32)  # (K, RPP)
                lane_g = ((t & (_LANE - 1))[:, None] == l_iota).astype(
                    jnp.float32
                )  # (K, 128)
                v_g = (
                    vw[g * Dout : (g + 1) * Dout].T[:, :, None]
                    * lane_g[:, None, :]
                ).reshape(K, Dout * _LANE)
                ms.append(m_g)
                vb.append(v_g)
            patch = jax.lax.dot_general(
                jnp.concatenate(ms, axis=0),
                jnp.concatenate(vb, axis=0),
                (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ).reshape(RPP, Dout, _LANE)
            blk = jax.lax.dynamic_slice(
                out, (r0 + q0, 0, 0), (RPP, Dout, _LANE)
            )
            out = jax.lax.dynamic_update_slice(
                out, blk + patch, (r0 + q0, 0, 0)
            )
        return c + count, out

    _, out = jax.lax.while_loop(cond, body, (jnp.int32(0), out))
    out = out.transpose(1, 0, 2).reshape(Dout, nrp * _LANE)[:, :n]
    return out[0] if squeeze else out


def scatter_set_int(
    n: int,
    lin: jnp.ndarray,
    val: jnp.ndarray,
    is_sorted: bool = False,
) -> jnp.ndarray:
    """out = zeros(n, i32); out[lin[c]] = val[..., c]; unique targets.

    Integer payloads ride the f32 matmul scatter in two 12-bit halves
    (f32 holds integers exactly to 2^24; volume-scale indices reach
    2^27+). Callers guarantee each in-range target is written at most
    once — with a zero base and unique targets, add == set.
    """
    squeeze = val.ndim == 1
    v = val[None, :] if squeeze else val
    v = jnp.asarray(v)
    lo = (v & 0xFFF).astype(jnp.float32)
    hi = (v >> 12).astype(jnp.float32)
    out = scatter_add_flat(
        n,
        lin,
        jnp.concatenate([lo, hi], axis=0),
        is_sorted=is_sorted,
    )
    d = v.shape[0]
    res = (
        jnp.round(out[:d]).astype(jnp.int32)
        + (jnp.round(out[d:]).astype(jnp.int32) << 12)
    )
    return res[0] if squeeze else res


# ---------------------------------------------------------------------------
# Gather whose adjoint is the matmul scatter (instead of XLA scatter-add).
# ---------------------------------------------------------------------------


@jax.custom_vjp
def take_flat(flat: jnp.ndarray, lin: jnp.ndarray) -> jnp.ndarray:
    """flat[lin] with clamped indices — identical forward to jnp.take,
    but its VJP into ``flat`` runs through ``scatter_add_flat``."""
    return jnp.take(flat, lin, axis=0, mode="clip")


def _take_flat_fwd(flat, lin):
    # zero-length probe carries the primal dtype into the backward pass
    return take_flat(flat, lin), (
        jnp.zeros((0,), flat.dtype), flat.shape[0], lin
    )


def _take_flat_bwd(res, g):
    probe, n, lin = res
    # forward clamps: replicate so the cotangent lands where the read came
    lin_flat = jnp.clip(lin.ravel(), 0, n - 1)
    df = scatter_add_flat(n, lin_flat, g.ravel().astype(jnp.float32))
    return df.astype(probe.dtype), np.zeros(lin.shape, jax.dtypes.float0)


take_flat.defvjp(_take_flat_fwd, _take_flat_bwd)


@partial(
    jax.jit,
    static_argnames=("window", "rows_per_patch", "fill_mode", "is_sorted"),
)
def gather_flat(
    table: jnp.ndarray,
    lin: jnp.ndarray,
    window: int = 2048,
    rows_per_patch: int = 256,
    fill_mode: str = "clip",
    is_sorted: bool | str = False,
) -> jnp.ndarray:
    """out[c] = table[lin[c]] — the gather DUAL of ``scatter_add_flat``.

    A gather from an arbitrary index stream without a gather operation,
    by the same method as the scatter: sort the stream, walk it with a
    static window, and turn each window into matmul work —

      1. sort (lin, arange) so each window of K indices spans a small
         contiguous row range of the flat table;
      2. per window: dynamic_slice an (RP, 128[, D]) patch, build the
         (K, RP) row one-hot, one matmul -> (K, 128[, D]) rows, then a
         lane one-hot select reduces to the K gathered values;
      3. un-sort with a second lax.sort keyed by the permutation.

    Everything static-shaped; the while-loop trip count is ~C/K for
    surface-like streams. Exactness never depends on the tuning values
    (a window spanning more than RP rows consumes a prefix and the
    cursor advances).

    Args:
      table: (n,) or (n, D) f32 source values.
      lin: (C,) int32 indices. fill_mode="clip": out-of-range indices
        clamp to the ends (``jnp.take`` mode="clip"); "zero": they
        return 0.0.
      window / rows_per_patch: static tuning (see scatter_add_flat).
      is_sorted: False = sort here (and un-sort the outputs). "trusted"
        = the caller GUARANTEES ``lin`` is non-decreasing with
        out-of-range entries only as a suffix (fill_mode="zero") —
        skips BOTH sorts (two lax.sort passes, the dominant cost for
        short streams). Entries after a violation gather from the wrong
        patch; use only where ascending holds by construction. True is
        REJECTED: scatter_add_flat's checked-hint semantics would need
        a lax.cond'd sort branch here (a compile bomb at volume scale),
        so the only non-sorting mode is the explicit "trusted".

    Returns:
      (C,) or (C, D) f32 gathered values, in the ORIGINAL stream order.
    """
    if fill_mode not in ("clip", "zero"):
        raise ValueError(f"fill_mode must be clip|zero, got {fill_mode!r}")
    if is_sorted not in (False, "trusted"):
        raise ValueError(
            "gather_flat is_sorted must be False or 'trusted' (True has "
            "no checked-hint mode here — see docstring)"
        )
    squeeze = table.ndim == 1
    tab = table[:, None] if squeeze else table
    n, D = tab.shape
    (C,) = lin.shape
    K = int(window)
    RP = int(rows_per_patch)
    nr = max(_round_up(n, _LANE) // _LANE, RP)

    lin = jnp.asarray(lin, jnp.int32)
    oob = (lin < 0) | (lin >= n)
    lin_c = jnp.clip(lin, 0, n - 1)
    if fill_mode == "zero":
        # zero-filled indices become the walk's terminating sentinel:
        # they sort to the end of the stream, the cursor never reaches
        # them, and their output rows keep the zero initialization —
        # a stream that is mostly dead slots costs only its live prefix.
        lin_c = jnp.where(oob, nr * _LANE, lin_c)

    if is_sorted == "trusted":
        lin_s, perm_s = lin_c, None
    else:
        perm = jnp.arange(C, dtype=jnp.int32)
        lin_s, perm_s = jax.lax.sort([lin_c, perm], num_keys=1)

    # pad the index stream with an n-row sentinel the walk terminates on
    lin_p = jnp.concatenate([lin_s, jnp.full((K,), nr * _LANE, jnp.int32)])
    tab_p = jnp.pad(
        jnp.asarray(tab, jnp.float32), ((0, nr * _LANE - n), (0, 0))
    ).reshape(nr, _LANE, D)

    out = jnp.zeros((C + K, D), jnp.float32)
    r_iota = jax.lax.broadcasted_iota(jnp.int32, (K, RP), 1)
    l_iota = jax.lax.broadcasted_iota(jnp.int32, (K, _LANE), 1)

    def cond(state):
        c, _ = state
        return (c < C) & (
            jax.lax.dynamic_slice(lin_p, (c,), (1,))[0] < nr * _LANE
        )

    def body(state):
        c, out = state
        lw = jax.lax.dynamic_slice(lin_p, (c,), (K,))
        rows = lw >> 7
        lanes = lw & (_LANE - 1)
        r0 = jnp.minimum(rows[0], nr - RP)
        local = rows - r0
        in_patch = local < RP  # sorted => a prefix of the window
        count = jnp.maximum(jnp.sum(in_patch.astype(jnp.int32)), 1)
        m = ((local[:, None] == r_iota) & in_patch[:, None]).astype(
            jnp.float32
        )  # (K, RP)
        patch = jax.lax.dynamic_slice(
            tab_p, (r0, 0, 0), (RP, _LANE, D)
        ).reshape(RP, _LANE * D)
        t = jax.lax.dot_general(
            m, patch, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).reshape(K, _LANE, D)
        lane_oh = (lanes[:, None] == l_iota).astype(jnp.float32)
        g = jnp.sum(t * lane_oh[:, :, None], axis=1)  # (K, D)
        out = jax.lax.dynamic_update_slice(out, g, (c, 0))
        return c + count, out

    _, out = jax.lax.while_loop(cond, body, (jnp.int32(0), out))
    out = out[:C]

    if perm_s is not None:
        # un-sort: a second key-sort by the permutation restores stream
        # order without a scatter
        _, *gs = jax.lax.sort(
            [perm_s] + [out[:, d] for d in range(D)], num_keys=1
        )
        out = jnp.stack(gs, axis=-1)
    if fill_mode == "zero":
        out = jnp.where(oob[:, None], 0.0, out)
    return out[:, 0] if squeeze else out

"""Batched O(nd) trace-point wave aligner on device (JAX/XLA).

A batched Local_Alignment (reference align.c:353-1946): many candidate
seeds are aligned simultaneously, one vmap lane per seed.  Per lane the
dynamically banded furthest-reaching wave runs as a
`lax.while_loop`; within a wave all diagonals advance vectorized over a
fixed-capacity ring band (the C implementation's memmove re-centering,
align.c:602-676, becomes slot = diag mod W).  Per-diagonal state is V
(furthest antidiagonal), the 61-bit match bitvector T (two uint32 words), the
match count M, next trace-mark positions NA/NB, and pebble-chain heads HA/HB
into a per-lane pebble pool.  Pebbles are appended with a cross-lane prefix
sum so the pointer graph is identical to the sequential reference.

The wave's in-wave sequential best/trim updates (align.c:819-833 run high
diagonal to low) are reproduced exactly with a reverse running-max: a
diagonal "triggers" iff its c exceeds all previously processed diagonals' c
and the old best; the surviving trim point is the lowest triggering diagonal
passing the suffix-positivity tables.

Trace extraction (pointer chasing) and the fshort/rshort double-pass
(align.c:1828-1854) run on host via the shared helpers in
damapper_tpu.ops.wave; lanes that overflow the band or pebble pool fall back
to the host oracle (rare; counted in stats).

damapper only ever calls Local_Alignment with a single seed diagonal and no
borders (map.c:2513), so the kernels specialize low==hgh, minp=-inf,
maxp=+inf, and no selfie handling.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .spec import AlignSpec, PATH_LEN, TRIM_LEN, TRIM_MLAG, WAVE_LAG
from . import wave as _host

_DBG = bool(os.environ.get('WAVE_JAX_DEBUG'))
_DEBUG_STOP = (int(os.environ['WAVE_JAX_STOP'])
               if os.environ.get('WAVE_JAX_STOP') else None)

INT32_MAX = np.int32(0x7FFFFFFF)
NEG_BIG = -np.int32(0x40000000)

PATH_TOP_HI_BIT = 28          # bit 60 of T lives in bit 28 of T_hi
THI_MASK = np.uint32((1 << 29) - 1)


def shard_lanes(fn, mesh, n_lane_args: int, n_args: int):
    """`fn` with its first `n_lane_args` arguments and all its outputs split
    over every device of `mesh`, and the other arguments replicated.  Lanes
    are independent, so each device runs its share with no collectives."""
    if mesh is None or mesh.size == 1:
        return fn
    from jax.sharding import PartitionSpec as P

    lanes = P(tuple(mesh.axis_names))
    in_specs = (lanes,) * n_lane_args + (P(),) * (n_args - n_lane_args)
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=lanes,
                         check_vma=False)


@functools.partial(jax.jit, static_argnames=("fields",))
def _pack_fields(fields, out):
    """Concatenate a dict of int32/bool arrays into one flat int32 buffer,
    so a chunk's results come back to the host in one transfer."""
    parts = []
    for f in fields:
        v = out[f]
        parts.append(v.astype(jnp.int32).reshape(-1))
    return jnp.concatenate(parts)


# process-wide jitted kernel pairs, shared across engine instances
_GLOBAL_FNS: dict = {}


@dataclass
class WaveResult:
    """Raw per-lane kernel outputs (host numpy)."""
    trima: np.ndarray
    trimy: np.ndarray
    trimd: np.ndarray
    trimha: np.ndarray
    trimhb: np.ndarray
    morem: np.ndarray
    morea: np.ndarray
    morey: np.ndarray
    mored: np.ndarray
    moreha: np.ndarray
    morehb: np.ndarray
    pool: np.ndarray        # (N, P, 4) int32: ptr, diag, diff, mark
    avail: np.ndarray
    overflow: np.ndarray
    waves: np.ndarray       # per-lane main-loop iteration count (telemetry)


def _mk_kernel(W: int, P: int, reverse: bool):
    """Build the single-lane wave function.  Only the band/pool capacities
    and the direction are compile-time constants; all spec parameters
    (trace spacing ts, ave-path threshold pave, suffix-positivity scores
    msc/dsc) are runtime scalars so one compiled kernel serves every
    dataset (the persistent compile cache then always hits).  The
    suffix-positivity trim tables are evaluated arithmetically in-kernel
    (a 15-step unrolled scan) instead of gathered from the 2^15-entry
    tables, which would be one vmapped gather per row.
    """
    Wm = W - 1
    sgn = -1 if reverse else 1

    def kernel(abase, bbase, mida, k0, aoffp, boffp, Aflat, Bflat,
               ts, pave, msc, dsc):
        TS = ts
        PATH_AVE = pave
        # sequence accessors; the reference's reverse pass decrements its
        # sequence pointers by one (align.c:1017-1018)
        soff = -1 if reverse else 0

        def bchar(y):
            return Bflat[bbase + y + soff]

        def achar(x):
            return Aflat[abase + x + soff]

        i32 = jnp.int32
        slots = jnp.arange(W, dtype=i32)
        # snake step-window width (wave-0 walks SS bases per gathered window;
        # the main-loop snake reads match PLANES instead, see _reload below)
        SS = 16
        stepv = jnp.arange(SS, dtype=i32) * sgn

        # --- carried sequence windows as match code planes -------------
        # The main loop's snake never touches Aflat/Bflat directly: per
        # ~W waves a contiguous window of each sequence is sliced out
        # (cheap: one 64-row gather per batch under vmap) and expanded
        # into int32 CODE planes indexed by (band slot, window column):
        #   code[s, j] = (j << 2) | (Bchar==4) << 1 | (Achar==4)
        #                 at columns where the snake stops (B sentinel or
        #                 mismatch), BIGC elsewhere
        # for the slot's two possible diagonal-to-window offsets (N/W
        # variants: slot s always holds diagonals == s mod W).  A wave's
        # snake is then ONE masked min-reduction per slot: the minimum code
        # at columns >= o yields both the run length and the stop cause.
        # For the reverse kernel the windows are flipped so columns still
        # advance with the walk.
        # Window width trades reload frequency against plane bytes: the
        # planes ride in the while-loop state, so smaller int16 planes cut
        # the state a wave carries.
        BW = max(128, W + 64)         # window columns (>= band y-span)
        AW = BW + 2 * W               # A window spans both offset variants
        LB = Bflat.shape[0]
        LA = Aflat.shape[0]
        jidx = jnp.arange(BW, dtype=i32)
        BIGC = jnp.int16(0x7FFF)

        def _reload(yref, low, hgh, anyact):
            """(Re)anchor the windows and rebuild the code planes.
            Returns (codeN, codeW, banchor, kanchor, bad)."""
            if not reverse:
                banchor = bbase + (yref - 4) + soff
                kanchor = W * (low // W)      # jnp // floors toward -inf
                astart = banchor + (abase - bbase) + kanchor
                bs = jnp.clip(banchor, 0, LB - BW)
                as_ = jnp.clip(astart, 0, LA - AW)
                bad = anyact & ((bs != banchor) | (as_ != astart))
                bwin = jax.lax.dynamic_slice(Bflat, (bs,), (BW,))
                awin = jax.lax.dynamic_slice(Aflat, (as_,), (AW,))
                banchor = bs
                offs = list(range(W))
            else:
                banchor = bbase + (yref + 4) + soff   # top column (j = 0)
                kanchor = W * ((hgh + W) // W)        # W*(floor(hgh/W)+1)
                atop = banchor + (abase - bbase) + kanchor
                bs = jnp.clip(banchor - (BW - 1), 0, LB - BW)
                as_ = jnp.clip(atop - (AW - 1), 0, LA - AW)
                bad = anyact & ((bs != banchor - (BW - 1)) |
                                (as_ != atop - (AW - 1)))
                banchor = bs + (BW - 1)
                bwin = jnp.flip(jax.lax.dynamic_slice(Bflat, (bs,), (BW,)))
                awin = jnp.flip(jax.lax.dynamic_slice(Aflat, (as_,), (AW,)))
                # reverse offset variant for slot s: (kanchor - k) with
                # k == s (mod W) -> W - s (W for s == 0), or that + W
                offs = [W if s == 0 else W - s for s in range(W)]
            aw2 = jnp.stack([awin[o:o + BW + W] for o in offs])  # (W, BW+W)
            awN = aw2[:, :BW]
            awW = aw2[:, W:W + BW]
            b4 = (bwin == 4)[None, :]

            def code(aw):
                stop = b4 | (bwin[None, :] != aw)
                val = ((jidx[None, :] << 2) | (b4.astype(i32) << 1) |
                       (aw == 4).astype(i32)).astype(jnp.int16)
                return jnp.where(stop, val, BIGC)

            return (code(awN), code(awW), banchor, kanchor, bad)

        # ---------------- wave 0: single diagonal k0 ----------------
        y0 = jnp.right_shift(mida - k0, 1)
        if not reverse:
            na0 = ((y0 + k0 + (TS - aoffp)) // TS - 1) * TS + aoffp
            nb0 = ((y0 + (TS - boffp)) // TS - 1) * TS + boffp
            amark0, bmark0 = na0, nb0
            na0 = na0 + TS
            nb0 = nb0 + TS
        else:
            na0 = ((y0 + k0 + (TS - aoffp) - 1) // TS - 1) * TS + aoffp
            nb0 = ((y0 + (TS - boffp) - 1) // TS - 1) * TS + boffp
            amark0, bmark0 = y0 + k0, y0

        pool = jnp.zeros((P, 4), i32)
        pool = pool.at[0].set(jnp.stack([i32(-1), k0, i32(0), amark0]))
        pool = pool.at[1].set(jnp.stack([i32(-1), k0, i32(0), bmark0]))
        avail = i32(2)
        ha0, hb0 = i32(0), i32(1)

        # wave-0 snake (scalar per lane, SS bases per trip)
        def s0_cond(st):
            y, stop, ca, cb = st
            return ~stop

        def s0_body(st):
            y, stop, ca, cb = st
            bwin = Bflat[jnp.clip(bbase + y + soff + stepv, 0,
                                  Bflat.shape[0] - 1)]
            awin = Aflat[jnp.clip(abase + y + k0 + soff + stepv, 0,
                                  Aflat.shape[0] - 1)]
            sbv = bwin == 4
            misv = bwin != awin
            advv = ((~sbv) & (~misv)).astype(jnp.int32)
            pref = jnp.cumprod(advv)
            nst = pref.sum()
            prefx = jnp.concatenate([jnp.ones((1,), jnp.int32), pref[:-1]])
            fs = (prefx * (1 - advv)).astype(bool)
            sb = (fs & sbv).any()
            sa = (fs & (~sbv) & misv & (awin == 4)).any()
            return (y + sgn * nst, nst < SS, ca | sa, cb | sb)

        y0f, _, clipA0, clipB0 = jax.lax.while_loop(
            s0_cond, s0_body, (y0, jnp.bool_(False), jnp.bool_(False),
                               jnp.bool_(False)))
        c0 = (y0f << 1) + k0
        more = ~(clipA0 | clipB0)
        aclip = jnp.where(clipA0, k0, (-INT32_MAX if reverse else INT32_MAX))
        bclip = jnp.where(clipB0, k0, (INT32_MAX if reverse else -INT32_MAX))

        # wave-0 pebble drops (scalar loop); carry the head cell's mark so
        # the main loop never has to re-read it from the pool
        def d0_cond(st):
            x, n, h, av, pl, mk = st
            return (x <= n) if reverse else (x >= n)

        def mk_d0_body(diff_v):
            def d0_body(st):
                x, n, h, av, pl, mk = st
                pl = pl.at[av].set(jnp.stack([h, k0, diff_v, n]),
                                   mode="drop")
                return (x, n - TS if reverse else n + TS,
                        jnp.where(av < P, av, h), av + 1, pl, n)
            return d0_body

        xA = y0f + k0
        xA, na0, ha0, avail, pool, amk0 = jax.lax.while_loop(
            d0_cond, mk_d0_body(i32(0)), (xA, na0, ha0, avail, pool, amark0))
        xB = y0f
        xB, nb0, hb0, avail, pool, bmk0 = jax.lax.while_loop(
            d0_cond, mk_d0_body(i32(0)), (xB, nb0, hb0, avail, pool, bmark0))

        better0 = (c0 < mida) if reverse else (c0 > mida)
        besta = jnp.where(better0, c0, mida)
        besty = jnp.where(better0, y0f, y0)
        lasta = besta
        trima = besta
        trimy = besty
        trimd = i32(0)
        trimha = jnp.where(better0, ha0, i32(0))
        trimhb = jnp.where(better0, hb0, i32(1))

        fill = NEG_BIG if not reverse else INT32_MAX
        V = jnp.full(W, fill, i32).at[k0 & Wm].set(c0)
        # PATH_INT = bits 0..59 set, bit 60 clear -> Thi = bits 32..59
        Thi = jnp.full(W, np.uint32((1 << 28) - 1), jnp.uint32)
        Tlo = jnp.full(W, np.uint32(0xFFFFFFFF), jnp.uint32)
        M = jnp.full(W, PATH_LEN, i32)
        NA = jnp.zeros(W, i32).at[k0 & Wm].set(na0)
        NB = jnp.zeros(W, i32).at[k0 & Wm].set(nb0)
        HA = jnp.zeros(W, i32).at[k0 & Wm].set(ha0)
        HB = jnp.zeros(W, i32).at[k0 & Wm].set(hb0)
        # head-cell marks (== pool[HA,3]/pool[HB,3], carried to avoid pool
        # reads in the drop loops)
        MA = jnp.zeros(W, i32).at[k0 & Wm].set(amk0)
        MB = jnp.zeros(W, i32).at[k0 & Wm].set(bmk0)

        # match-plane state: invalid anchors force a reload on wave 1
        codeN = jnp.zeros((W, BW), jnp.int16)
        codeW = jnp.zeros((W, BW), jnp.int16)
        banchor = i32(-(1 << 30))
        kanchor = i32(-(1 << 30))

        low = k0
        hgh = k0
        morem = i32(-1)
        morea = i32(0)
        morey = i32(0)
        mored = i32(0)
        moreha = i32(0)
        morehb = i32(0)

        # wave-0 clip handling (align.c:558-583 / 1216-1241).  Slot values at
        # the clipped diagonal are fetched with a one-hot mask reduction over
        # the band instead of dynamic indexing (vmapped dynamic indexing
        # lowers to per-lane gathers).
        def clip_block(more_in, low, hgh, aclip, bclip, besta, besty,
                       V, M, HA, HB, kvec, morem, morea, morey, mored,
                       moreha, morehb, dif, set_mored):
            clipped = ~more_in
            rest = (bchar(besty) != 4) & (achar(besta - besty) != 4)
            if not reverse:
                hit_a = clipped & (hgh >= aclip)
                hit_b = clipped & (low <= bclip)
            else:
                hit_a = clipped & (low <= aclip)
                hit_b = clipped & (hgh >= bclip)

            def grab(kc, morem, morea, morey, mored, moreha, morehb, hit):
                sel = kvec == kc      # at most one band slot matches
                Mv = jnp.sum(jnp.where(sel, M, 0))
                Vv = jnp.sum(jnp.where(sel, V, 0))
                HAv = jnp.sum(jnp.where(sel, HA, 0))
                HBv = jnp.sum(jnp.where(sel, HB, 0))
                upd = hit & (morem <= Mv)
                morem = jnp.where(upd, Mv, morem)
                morea = jnp.where(upd, Vv, morea)
                morey = jnp.where(upd, (Vv - kc) // 2, morey)
                if set_mored:
                    mored = jnp.where(upd, dif, mored)
                moreha = jnp.where(upd, HAv, moreha)
                morehb = jnp.where(upd, HBv, morehb)
                return morem, morea, morey, mored, moreha, morehb

            morem, morea, morey, mored, moreha, morehb = grab(
                aclip, morem, morea, morey, mored, moreha, morehb, hit_a)
            morem, morea, morey, mored, moreha, morehb = grab(
                bclip, morem, morea, morey, mored, moreha, morehb, hit_b)
            if not reverse:
                hgh = jnp.where(hit_a, aclip - 1, hgh)
                low = jnp.where(hit_b, bclip + 1, low)
            else:
                low = jnp.where(hit_a, aclip + 1, low)
                hgh = jnp.where(hit_b, bclip - 1, hgh)
            more_out = jnp.where(clipped, rest, more_in)
            return (more_out, low, hgh, morem, morea, morey, mored,
                    moreha, morehb)

        kvec0 = k0 + jnp.remainder(slots - k0, W)
        (more, low, hgh, morem, morea, morey, mored, moreha, morehb) = \
            clip_block(more, low, hgh, aclip, bclip, besta, besty, V, M,
                       HA, HB, kvec0, morem, morea, morey, mored, moreha,
                       morehb, i32(0), set_mored=False)

        overflow = jnp.bool_(False)

        # ---------------- main wave loop ----------------
        state = (V, Thi, Tlo, M, NA, NB, HA, HB, pool, avail, low, hgh,
                 i32(0), more, besta, besty, lasta, trima, trimy, trimd,
                 trimha, trimhb, morem, morea, morey, mored, moreha, morehb,
                 overflow, MA, MB, codeN, codeW, banchor, kanchor)

        def cond(st):
            (V, Thi, Tlo, M, NA, NB, HA, HB, pool, avail, low, hgh, dif,
             more, besta, besty, lasta, trima, trimy, trimd, trimha, trimhb,
             morem, morea, morey, mored, moreha, morehb, overflow,
             MA, MB, codeN, codeW, banchor, kanchor) = st
            if reverse:
                go = lasta <= besta + TRIM_MLAG
            else:
                go = lasta >= besta - TRIM_MLAG
            if _DEBUG_STOP is not None:
                go = go & (dif < _DEBUG_STOP)
            return more & go & ~overflow

        def body(st):
            (V, Thi, Tlo, M, NA, NB, HA, HB, pool, avail, low, hgh, dif,
             more, besta, besty, lasta, trima, trimy, trimd, trimha, trimhb,
             morem, morea, morey, mored, moreha, morehb, overflow,
             MA, MB, codeN, codeW, banchor, kanchor) = st

            # own-lane liveness (same predicate as `cond`): under vmap the
            # batched while re-executes this body for lanes that already
            # finished, and their stale state would otherwise re-run the
            # nested snake/drop loops on every remaining combined iteration
            # (a quadratic blowup for heterogeneous batches).  Gating the
            # inner loops on `live` makes finished lanes contribute zero
            # inner iterations; their body results are discarded by the
            # outer select, so single-lane semantics are unchanged.
            live = cond(st)

            low = low - 1
            hgh = hgh + 1
            overflow = overflow | (hgh - low + 4 >= W) | (avail + W >= P)
            if _DBG:
                jax.debug.print("wave dif={d} low={l} hgh={h}", d=dif, l=low,
                                h=hgh)

            # border slot init via one-hot masks: dynamic scalar indexing
            # under vmap lowers to per-lane gathers
            sl = low & Wm
            sh = hgh & Wm
            is_sl = slots == sl
            is_sh = slots == sh

            def at_slot(arr, s):
                return jnp.sum(jnp.where(slots == s, arr, 0))

            V = jnp.where(is_sl | is_sh, fill, V)
            na_lo, na_hi = at_slot(NA, (low + 1) & Wm), at_slot(NA,
                                                               (hgh - 1) & Wm)
            nb_lo, nb_hi = at_slot(NB, (low + 1) & Wm), at_slot(NB,
                                                               (hgh - 1) & Wm)
            NA = jnp.where(is_sl, na_lo, jnp.where(is_sh, na_hi, NA))
            NB = jnp.where(is_sl, nb_lo, jnp.where(is_sh, nb_hi, NB))
            dif = dif + 1

            k = low + jnp.remainder(slots - low, W)
            in_band = k <= hgh

            Vm = jnp.where(in_band, V, fill)
            ap = jnp.roll(Vm, -1)   # V[k+1]
            am = jnp.roll(Vm, 1)    # V[k-1]
            ac = Vm

            if not reverse:
                pickP = jnp.where(ac < am, am < ap, ac < ap)
                pickM = (ac < am) & ~pickP
                c = jnp.where(pickP, ap + 1,
                              jnp.where(pickM, am + 1, ac + 2))
            else:
                pickM = jnp.where(ac > ap, ap > am, ac > am)
                pickP = (ac > ap) & ~pickM
                c = jnp.where(pickM, am - 1,
                              jnp.where(pickP, ap - 1, ac - 2))

            def pick3(arr):
                return jnp.where(pickP, jnp.roll(arr, -1),
                                 jnp.where(pickM, jnp.roll(arr, 1), arr))

            m = pick3(M)
            thi = pick3(Thi)
            tlo = pick3(Tlo)
            ha = pick3(HA)
            hb = pick3(HB)
            ma = pick3(MA)
            mb = pick3(MB)

            top = (thi >> PATH_TOP_HI_BIT) & 1
            m = m - top.astype(i32)
            thi = ((thi << 1) | (tlo >> 31)) & THI_MASK
            tlo = tlo << 1

            y = jnp.right_shift(c - k, 1)

            # snake: run lengths come from the carried match planes; the
            # only sequence access is the (rare) window reload, wrapped in
            # a 0/1-trip while so it costs nothing when anchors are valid
            if not reverse:
                offN_vec = slots
            else:
                offN_vec = jnp.asarray(
                    [W if s == 0 else W - s for s in range(W)], i32)

            def sn_state_o(y, banchor):
                if not reverse:
                    return (bbase + y + soff) - banchor
                return banchor - (bbase + y + soff)

            def sn_invalid(y, act, banchor, kanchor):
                o = sn_state_o(y, banchor)
                off = (k - kanchor) if not reverse else (kanchor - k)
                wrap = off == offN_vec + W
                valid_off = (off == offN_vec) | wrap
                inv = act & (~valid_off | (o < 0) | (o > BW - SS))
                return o, wrap, valid_off, inv

            def sn_cond(sst):
                return sst[4].any()     # act

            def sn_body(sst):
                (y, thi, tlo, m, act, ca, cb, codeN, codeW,
                 banchor, kanchor, ovf) = sst

                # reload windows/planes only when an active slot left them
                o, wrap, valid_off, inv = sn_invalid(y, act, banchor,
                                                     kanchor)

                def r_cond(rst):
                    return ~rst[0] & inv.any()

                def r_body(rst):
                    _, codeN, codeW, banchor, kanchor, ovf = rst
                    big = INT32_MAX if not reverse else -INT32_MAX
                    if not reverse:
                        yref = jnp.min(jnp.where(act, y, big))
                    else:
                        yref = jnp.max(jnp.where(act, y, big))
                    codeN, codeW, banchor, kanchor, bad = \
                        _reload(yref, low, hgh, act.any())
                    return (jnp.bool_(True), codeN, codeW,
                            banchor, kanchor, ovf | bad)

                (_, codeN, codeW, banchor, kanchor, ovf) = \
                    jax.lax.while_loop(
                        r_cond, r_body,
                        (jnp.bool_(False), codeN, codeW,
                         banchor, kanchor, ovf))
                o, wrap, valid_off, inv = sn_invalid(y, act, banchor,
                                                     kanchor)
                usable = act & ~inv     # still-invalid slots defer a trip

                # ONE masked min-reduction gives the first stop column >= o
                # and its stop cause (bits 1:0 of the code)
                oc = jnp.clip(o, 0, BW - 1)
                jm = jidx[None, :] >= oc[:, None]
                csel = jnp.where(wrap[:, None], codeW, codeN)
                r = jnp.min(jnp.where(jm, csel, BIGC), axis=1).astype(i32)
                found = r < 0x7FFF
                jstar = jnp.where(found, r >> 2, BW)
                run = jstar - oc
                nst = jnp.where(usable, jnp.minimum(run, SS), 0)
                adv_done = usable & (run <= SS) & found

                sbv = ((r >> 1) & 1) == 1
                a4s = (r & 1) == 1
                sb = adv_done & sbv
                sa = adv_done & ~sbv & a4s

                # batch-update the 61-bit path vector: append nst match bits;
                # the match count loses the bits shifted out of the window
                nu = nst.astype(jnp.uint32)
                ext = (thi >> (29 - nu)) & ((jnp.uint32(1) << nu) - 1)
                pops = jax.lax.population_count(ext).astype(i32)
                nthi = ((thi << nu) |
                        jnp.where(nst == 0, jnp.uint32(0),
                                  tlo >> (32 - nu))) & THI_MASK
                ntlo = (tlo << nu) | ((jnp.uint32(1) << nu) - 1)
                m = jnp.where(usable, m + nst - pops, m)
                thi = jnp.where(usable, nthi, thi)
                tlo = jnp.where(usable, ntlo, tlo)
                y = jnp.where(usable, y + sgn * nst, y)
                act = act & ~adv_done
                return (y, thi, tlo, m, act, ca | sa, cb | sb, codeN,
                        codeW, banchor, kanchor, ovf)

            false_w = jnp.zeros(W, bool)
            (y, thi, tlo, m, _, clipA, clipB, codeN, codeW,
             banchor, kanchor, overflow) = jax.lax.while_loop(
                sn_cond, sn_body,
                (y, thi, tlo, m, in_band & live, false_w, false_w,
                 codeN, codeW, banchor, kanchor, overflow))
            c = (y << 1) + k

            clip_any = (clipA | clipB).any()
            more = more & ~clip_any
            if not reverse:
                aclip = jnp.min(jnp.where(clipA, k, INT32_MAX))
                bclip = jnp.max(jnp.where(clipB, k, -INT32_MAX))
            else:
                aclip = jnp.max(jnp.where(clipA, k, -INT32_MAX))
                bclip = jnp.min(jnp.where(clipB, k, INT32_MAX))

            # pebble drops (vectorized, prefix-sum slot allocation).  The
            # head cell's mark rides along in ma/mb so no pool read is
            # needed; the check pool[H].mark </> N suppresses duplicate
            # drops on the same trace line after a pick3 inheritance.
            # A and B sides share ONE loop (stacked on a leading axis of
            # 2), and scatter indices are made globally unique so XLA can
            # use the fast unique-indices scatter lowering.
            inb = in_band & live
            X2 = jnp.stack([y + k, y])                 # (2, W)
            N2 = jnp.stack([NA, NB])
            H2 = jnp.stack([ha, hb])
            MK2 = jnp.stack([ma, mb])
            slot2 = jnp.arange(2 * W, dtype=i32)

            def dcond(dst):
                N2, H2, MK2, av, pl, ov = dst
                if reverse:
                    return (inb[None, :] & (X2 <= N2)).any()
                return (inb[None, :] & (X2 >= N2)).any()

            def dbody(dst):
                N2, H2, MK2, av, pl, ov = dst
                if reverse:
                    act = inb[None, :] & (X2 <= N2)
                    need = act & (MK2 > N2)
                else:
                    act = inb[None, :] & (X2 >= N2)
                    need = act & (MK2 < N2)
                nf = need.reshape(-1)
                cs = jnp.cumsum(nf.astype(i32))
                idx = av + cs - 1
                widx = jnp.where(nf, idx, P + slot2)   # unique also when
                rows = jnp.stack([H2.reshape(-1),      # dropped (OOB)
                                  jnp.concatenate([k, k]),
                                  jnp.full(2 * W, dif),
                                  N2.reshape(-1)], axis=1)
                pl = pl.at[widx].set(rows, mode="drop", unique_indices=True)
                idx2 = idx.reshape(2, W)
                H2 = jnp.where(need, idx2, H2)
                MK2 = jnp.where(need, N2, MK2)
                nav = av + cs[-1]
                ov = ov | (nav >= P)
                N2 = jnp.where(act, N2 - TS if reverse else N2 + TS, N2)
                return (N2, H2, MK2, jnp.minimum(nav, P), pl, ov)

            N2, H2, MK2, avail, pool, overflow = jax.lax.while_loop(
                dcond, dbody, (N2, H2, MK2, avail, pool, overflow))
            NA, NB = N2[0], N2[1]
            ha, hb = H2[0], H2[1]
            ma, mb = MK2[0], MK2[1]

            # best/trim updates with the reference's sequential-order
            # semantics (hgh->low for forward, low->hgh for reverse).
            # Everything runs in SLOT space: the band's low..hgh order is a
            # rotation of slot order, so position-ordered suffix/prefix
            # scans decompose into two masked slot-order scans (upper
            # segment slots >= low mod W come first, lower segment wraps).
            # This avoids per-lane dynamic rolls, which XLA lowers to
            # element-serialized gathers.
            rel = jnp.remainder(slots - low, W)       # position of each slot
            low0 = jnp.remainder(low, W)
            maskU = slots >= low0

            if not reverse:
                cU = jnp.where(in_band & maskU, c, NEG_BIG)
                cL = jnp.where(in_band & ~maskU, c, NEG_BIG)
                sufU = jax.lax.cummax(cU, axis=0, reverse=True)
                sufL = jax.lax.cummax(cL, axis=0, reverse=True)
                maxL = jnp.max(cL)
                pad = jnp.array([NEG_BIG], i32)
                sufU_x = jnp.concatenate([sufU[1:], pad])
                sufL_x = jnp.concatenate([sufL[1:], pad])
                suf_excl = jnp.where(maskU, jnp.maximum(sufU_x, maxL),
                                     sufL_x)
                runbase = jnp.maximum(besta, suf_excl)
                trigger = in_band & (c > runbase)
                new_besta = jnp.maximum(
                    besta, jnp.max(jnp.where(in_band, c, NEG_BIG)))
            else:
                cU = jnp.where(in_band & maskU, c, INT32_MAX)
                cL = jnp.where(in_band & ~maskU, c, INT32_MAX)
                preU = jax.lax.cummin(cU, axis=0)
                preL = jax.lax.cummin(cL, axis=0)
                minU = jnp.min(cU)
                pad = jnp.array([INT32_MAX], i32)
                preU_x = jnp.concatenate([pad, preU[:-1]])
                preL_x = jnp.concatenate([pad, preL[:-1]])
                pre_excl = jnp.where(maskU, preU_x,
                                     jnp.minimum(preL_x, minU))
                runbase = jnp.minimum(besta, pre_excl)
                trigger = in_band & (c < runbase)
                new_besta = jnp.minimum(
                    besta, jnp.min(jnp.where(in_band, c, INT32_MAX)))

            cb_, y_b, m_b, ha_b, hb_b, tlo_b = c, y, m, ha, hb, tlo

            i1 = (tlo_b & 0x7FFF).astype(jnp.int32)
            i2 = ((tlo_b >> 15) & 0x7FFF).astype(jnp.int32)
            # arithmetic trim tables: table[x] = total - max(0, maxpref),
            # score[x] = total over the 15-column window (spec.py)
            def tbl(x):
                cum = jnp.zeros_like(x)
                maxp = jnp.zeros_like(x)
                for ii in range(TRIM_LEN - 1, -1, -1):
                    bit = (x >> ii) & 1
                    cum = cum + jnp.where(bit == 1, msc, -dsc)
                    maxp = jnp.maximum(maxp, cum)
                return cum - maxp, cum
            t1, s1 = tbl(i1)
            t2, _ = tbl(i2)
            tbl_ok = (t1 >= 0) & (t2 + s1 >= 0)
            m_ok = m_b >= PATH_AVE

            if not reverse:
                chosen = lambda msk: jnp.min(jnp.where(msk, rel, W))
            else:
                chosen = lambda msk: jnp.max(jnp.where(msk, rel, -1))

            def pick_at(msk, arr):
                oneh = msk & (rel == chosen(msk))
                return jnp.sum(jnp.where(oneh, arr, 0))

            any0 = trigger.any()
            besty = jnp.where(any0, pick_at(trigger, y_b), besty)
            besta = new_besta

            trig_m = trigger & m_ok
            any1 = trig_m.any()
            lasta = jnp.where(any1, pick_at(trig_m, cb_), lasta)

            trig_t = trig_m & tbl_ok
            any2 = trig_t.any()
            trima = jnp.where(any2, pick_at(trig_t, cb_), trima)
            trimy = jnp.where(any2, pick_at(trig_t, y_b), trimy)
            trimd = jnp.where(any2, dif, trimd)
            trimha = jnp.where(any2, pick_at(trig_t, ha_b), trimha)
            trimhb = jnp.where(any2, pick_at(trig_t, hb_b), trimhb)

            # store band state
            V = jnp.where(in_band, c, V)
            Thi = jnp.where(in_band, thi, Thi)
            Tlo = jnp.where(in_band, tlo, Tlo)
            M = jnp.where(in_band, m, M)
            HA = jnp.where(in_band, ha, HA)
            HB = jnp.where(in_band, hb, HB)
            MA = jnp.where(in_band, ma, MA)
            MB = jnp.where(in_band, mb, MB)

            # clip block
            (more, low, hgh, morem, morea, morey, mored, moreha, morehb) = \
                clip_block(more, low, hgh, aclip, bclip, besta, besty, V, M,
                           HA, HB, k, morem, morea, morey, mored, moreha,
                           morehb, dif, set_mored=True)

            # band prune (align.c:877-885).  Positions MUST be relative to
            # the POST-clip low: clip_block may have just raised low (rev
            # aclip / fwd bclip), and re-using the pre-clip `rel` here
            # re-based the band `delta` diagonals too high — losing the
            # slots just above aclip, whose later boundary re-clips carry
            # better REACH grabs (the 50k-read parity edge; tools/clip_fuzz).
            rel2 = jnp.remainder(slots - low, W)
            k2 = low + rel2
            inb2 = k2 <= hgh
            if not reverse:
                ok = inb2 & (V >= besta - WAVE_LAG)
            else:
                ok = inb2 & (V <= besta + WAVE_LAG)
            okpos = jnp.where(ok, rel2, -1)
            hi_rel = jnp.max(okpos)
            lo_rel = jnp.min(jnp.where(okpos >= 0, okpos, W))
            have = hi_rel >= 0
            hgh = jnp.where(have, low + hi_rel, hgh)
            low = jnp.where(have, low + jnp.minimum(lo_rel, hi_rel), low)

            return (V, Thi, Tlo, M, NA, NB, HA, HB, pool, avail, low, hgh,
                    dif, more, besta, besty, lasta, trima, trimy, trimd,
                    trimha, trimhb, morem, morea, morey, mored, moreha,
                    morehb, overflow, MA, MB, codeN, codeW,
                    banchor, kanchor)

        st = jax.lax.while_loop(cond, body, state)
        (V, Thi, Tlo, M, NA, NB, HA, HB, pool, avail, low, hgh, dif, more,
         besta, besty, lasta, trima, trimy, trimd, trimha, trimhb, morem,
         morea, morey, mored, moreha, morehb, overflow, MA, MB,
         codeN, codeW, banchor, kanchor) = st

        out = dict(trima=trima, trimy=trimy, trimd=trimd, trimha=trimha,
                   trimhb=trimhb, morem=morem, morea=morea, morey=morey,
                   mored=mored, moreha=moreha, morehb=morehb, pool=pool,
                   avail=avail, overflow=overflow, waves=dif)
        if _DEBUG_STOP is not None:
            out.update(V=V, M=M, Thi=Thi, Tlo=Tlo, low=low, hgh=hgh,
                       besta=besta, lasta=lasta, more=more, besty=besty)
        return out

    return kernel


class WaveEngine:
    """Batched device Local_Alignment with host oracle fallback.

    With ``mesh`` the lane batch is sharded over the mesh's "dp" axis
    (NamedSharding via GSPMD): every wave op is elementwise over lanes, so
    the kernel partitions across chips with no collectives — the multi-chip
    analog of the reference's per-thread a-read ranges (map.c:3145-3157).
    Sequence memory and the spec tables are replicated.
    """

    def __init__(self, spec: AlignSpec, band_cap: int = 64,
                 pool_cap: int = 2048, mesh=None):
        self.spec = spec
        self.W = band_cap
        self.P = pool_cap
        self.mesh = mesh
        self._consts = (jnp.int32(spec.trace_space), jnp.int32(spec.ave_path),
                        jnp.int32(spec.mscore), jnp.int32(spec.dscore))
        self._fns = {}          # pool bucket -> (fwd, rev) jitted
        self._ndp = mesh.shape["dp"] if mesh is not None else 1
        self._activeP = pool_cap
        self.n_fallback = 0
        self.n_total = 0
        self.n_hostmin = 0      # lanes routed to the host oracle (tiny rounds)
        self.total_waves = 0    # summed per-lane wave counts (telemetry)
        self.t_run = 0.0        # seconds inside _run (device + pull wait)
        self.t_batch = 0.0      # seconds inside local_alignment_batch
        # rounds smaller than HOST_MIN lanes run on the host oracle (it is
        # bit-identical); DAMAPPER_WAVE_HOSTMIN overrides
        self.host_min = int(os.environ.get("DAMAPPER_WAVE_HOSTMIN",
                                           self.HOST_MIN))

    def _get_fns(self, P: int):
        """Jitted kernel pair for a pool-capacity bucket.  The pool rides
        in the while state, so capacity is sized per batch
        (local_alignment_batch) rather than worst-case.

        Pairs are memoized process-wide (keyed on band/pool shape and mesh):
        engines are cheap to construct, and without this every engine would
        re-trace and re-compile identical kernels — a test suite builds
        hundreds of engines, and the duplicate LLVM work both slows it and
        has been observed to crash XLA's CPU backend late in the process."""
        gkey = (self.W, P, None if self.mesh is None
                else (id(self.mesh), tuple(self.mesh.shape.items())))
        if P not in self._fns and gkey in _GLOBAL_FNS:
            self._fns[P] = _GLOBAL_FNS[gkey]
        if P not in self._fns:
            vm = functools.partial(jax.vmap,
                                   in_axes=(0, 0, 0, 0, 0, 0, None, None,
                                            None, None, None, None))
            fwd = vm(_mk_kernel(self.W, P, reverse=False))
            rev = vm(_mk_kernel(self.W, P, reverse=True))
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P_
                dp = NamedSharding(self.mesh, P_("dp"))
                rep = NamedSharding(self.mesh, P_())
                shardings = ([dp] * 6) + ([rep] * 6)
                self._fns[P] = (jax.jit(fwd, in_shardings=shardings),
                                jax.jit(rev, in_shardings=shardings))
            else:
                self._fns[P] = (jax.jit(fwd), jax.jit(rev))
            _GLOBAL_FNS[gkey] = self._fns[P]
        return self._fns[P]

    # rounds below this many lanes go to the host oracle.  Measured on an
    # H100 (tools/wave_engine_ab.py): a round costs this engine ~150 ms
    # for one lane and ~500 ms for 32, the oracle ~20 ms per lane, so the
    # two break even near 32 lanes
    HOST_MIN = 32
    # largest chunk of lanes per call: batches pad to the next power of two
    # up to it (bounding compiled shapes) and larger ones are chunked.  A
    # lockstep chunk runs to its slowest lane, so smaller chunks idle less.
    BUCKET = int(os.environ.get("DAMAPPER_WAVE_BUCKET", 128))
    # chunks dispatched ahead of the pull cursor (bounds device memory:
    # each in-flight chunk holds a packed output incl. its (B,P,4) pool)
    PIPELINE = int(os.environ.get("DAMAPPER_WAVE_PIPELINE", 4))

    def _run(self, which, abase, bbase, mida, k0, aoffp, boffp,
             Aflat, Bflat, sortkey=None) -> WaveResult:
        _t0 = time.perf_counter()
        try:
            return self._run_inner(which, abase, bbase, mida, k0, aoffp,
                                   boffp, Aflat, Bflat, sortkey)
        finally:
            self.t_run += time.perf_counter() - _t0

    def _run_inner(self, which, abase, bbase, mida, k0, aoffp, boffp,
                   Aflat, Bflat, sortkey=None) -> WaveResult:
        P = self._activeP
        fn = self._get_fns(P)[0 if which == "fwd" else 1]
        n = len(abase)
        if n == 0:
            z = np.zeros(0, np.int32)
            return WaveResult(*([z] * 11),
                              np.zeros((0, P, 4), np.int32),
                              z, np.zeros(0, bool), z)
        # lifetime-sorted lane scheduling: kernel groups of G lanes run in
        # lockstep, so a group costs as many iterations as its LONGEST lane.
        # Ordering lanes by a max-extension proxy makes groups homogeneous
        # (the permutation is undone on output, so results are unchanged).
        order = None
        if (sortkey is not None and n > 8
                and os.environ.get("DAMAPPER_WAVE_SORT", "1") == "1"):
            order = np.argsort(np.asarray(sortkey), kind="stable")
            inv = np.empty(n, np.int64)
            inv[order] = np.arange(n)
        # bucket = next power of two, capped at BUCKET; larger batches are
        # chunked.  Bounds the number of distinct compiled shapes while
        # keeping small batches cheap.  Sharded engines need lanes divisible
        # by the dp axis.
        B = min(self.BUCKET, max(8, self._ndp,
                                 1 << (n - 1).bit_length()))
        if self._ndp > 1 and B % self._ndp:
            # a sharded batch dimension must divide the dp mesh axis
            B = -(-B // self._ndp) * self._ndp
        args = [np.asarray(x, np.int32)
                for x in (abase, bbase, mida, k0, aoffp, boffp)]
        if order is not None:
            args = [x[order] for x in args]
        # degenerate filler seed: a wave anchored on the leading sentinel
        # (seq[0] == 4) terminates after one wave, so padded lanes stall
        # their group immediately instead of redundantly recomputing lane 0
        fill = dict(abase=0, bbase=0, mida=0, k0=0, aoffp=0, boffp=0)
        names = ("abase", "bbase", "mida", "k0", "aoffp", "boffp")
        # chunk pipeline: keep up to PIPELINE chunks dispatched ahead of the
        # pull cursor (JAX dispatch is async, so the device queue fills
        # immediately).  While the host waits on chunk i's device->host
        # transfer the device is already computing chunks i+1..; the depth
        # bound caps how many packed output buffers (incl. the (B,P,4)
        # pool) coexist on device.
        chunks = []

        def _pull(item):
            nkeep, fields, shapes, flat = item
            flat = np.asarray(flat)
            unpacked = {}
            off = 0
            for f in fields:
                shp, dt = shapes[f]
                sz = int(np.prod(shp)) if shp else 1
                arr = flat[off:off + sz].reshape(shp if shp else ())
                off += sz
                if dt == jnp.bool_:
                    arr = arr.astype(bool)
                unpacked[f] = arr
            chunks.append({f: v[:nkeep] for f, v in unpacked.items()})

        pending = []
        for st in range(0, n, B):
            en = min(st + B, n)
            def pad(x, nm):
                x = x[st:en]
                if len(x) == B:
                    return jnp.asarray(x)
                return jnp.asarray(np.concatenate(
                    [x, np.full(B - len(x), fill[nm], np.int32)]))
            out = fn(*[pad(x, nm) for x, nm in zip(args, names)],
                     Aflat, Bflat, *self._consts)
            # one device->host transfer for the whole result set
            fields = sorted(out)
            flat = _pack_fields(tuple(fields), out)
            shapes = {f: (out[f].shape, out[f].dtype) for f in fields}
            pending.append((en - st, fields, shapes, flat))
            if len(pending) > self.PIPELINE:
                _pull(pending.pop(0))
        for item in pending:
            _pull(item)
        merged = {f: np.concatenate([c[f] for c in chunks])
                  for f in chunks[0]}
        if order is not None:
            merged = {f: v[inv] for f, v in merged.items()}
        self.total_waves += int(merged["waves"].sum())
        return WaveResult(**merged)

    # ---- full Local_Alignment over a batch of seeds ----

    def local_alignment_batch(self, Aflat, Bflat, Anp, Bnp, seeds):
        """seeds: list of dicts with abase, alen, bbase, blen, diag, anti,
        flags.  Aflat/Bflat are device uint8 arrays of the loaded sequence
        memory (with `4` sentinels); Anp/Bnp the same as host numpy (for
        fallback + trace walking).  Returns list of (apath, bpath)."""
        _t0 = time.perf_counter()
        try:
            return self._batch_inner(Aflat, Bflat, Anp, Bnp, seeds)
        finally:
            self.t_batch += time.perf_counter() - _t0

    def _batch_inner(self, Aflat, Bflat, Anp, Bnp, seeds):
        n = len(seeds)
        self.n_total += n
        TS = self.spec.trace_space
        out = [None] * n
        if os.environ.get("DAMAPPER_WAVE_DUMP"):
            # debug: append every batch's seed list for offline
            # engine-vs-oracle parity replay (chip_smoke.py phase c)
            import pickle
            with open(os.environ["DAMAPPER_WAVE_DUMP"], "ab") as fh:
                pickle.dump(seeds, fh)

        if n < self.host_min:
            self.n_hostmin += n
            for i, s in enumerate(seeds):
                a_np = Anp[s["abase"]:s["abase"] + s["alen"]]
                b_np = Bnp[s["bbase"]:s["bbase"] + s["blen"]]
                out[i] = _host.local_alignment(
                    a_np, b_np, self.spec, int(s["diag"]), int(s["diag"]),
                    int(s["anti"]), -1, -1, int(s["flags"]))
            return out

        # pool bucket: pebbles per lane are bounded by the aligned span
        # (two trace lines per TS columns on each side of a < 2*alen-wide
        # extension) + wave-0 drops + slack
        need = 4 * int(max(s["alen"] for s in seeds)) // TS + 128
        self._activeP = int(min(self.P,
                                max(256, 1 << (need - 1).bit_length())))

        abase = np.array([s["abase"] for s in seeds], np.int32)
        bbase = np.array([s["bbase"] for s in seeds], np.int32)
        alen = np.array([s["alen"] for s in seeds], np.int32)
        blen = np.array([s["blen"] for s in seeds], np.int32)
        diag = np.array([s["diag"] for s in seeds], np.int32)
        anti = np.array([s["anti"] for s in seeds], np.int32)
        flags = np.array([s["flags"] for s in seeds], np.int32)

        aoffp = np.where(flags & _host.ACOMP_FLAG, alen % TS, 0).astype(np.int32)
        boffp = np.where(flags & _host.COMP_FLAG, blen % TS, 0).astype(np.int32)

        x0 = (anti + diag) // 2
        y0 = (anti - diag) // 2
        f = self._run("fwd", abase, bbase, anti, diag, aoffp, boffp,
                      Aflat, Bflat,
                      sortkey=np.minimum(alen - x0, blen - y0))

        apaths = [None] * n
        fwd_a = [None] * n
        fwd_b = [None] * n
        low2 = np.zeros(n, np.int32)
        fallback = set(np.flatnonzero(f.overflow).tolist())
        for i in range(n):
            if i in fallback:
                continue
            trimx, trimy, trimd, trimha, trimhb = _reach_select(
                f, i, self.spec.reach)
            cells = f.pool[i]
            lowi, fwd, btr = _host.extract_forward_traces(
                cells, trimha, trimhb, trimx, trimy, trimd, int(anti[i]))
            ap = _host.PathRec(aepos=fwd.aepos, bepos=fwd.bepos,
                               diffs=fwd.diffs)
            apaths[i] = ap
            fwd_a[i] = fwd.trace
            fwd_b[i] = btr
            low2[i] = lowi

        r = self._run("rev", abase, bbase, anti, low2, aoffp, boffp,
                      Aflat, Bflat,
                      sortkey=np.minimum((anti + low2) // 2,
                                         (anti - low2) // 2))
        for i in range(n):
            if i in fallback:
                continue
            if r.overflow[i]:
                fallback.add(i)
                continue
            trimx, trimy, trimd, trimha, trimhb = _reach_select(
                r, i, self.spec.reach)
            ap = apaths[i]
            a_pre, b_pre = _host.extract_reverse_traces(
                r.pool[i], trimha, trimhb, trimx, trimy, trimd, TS,
                int(aoffp[i]), int(boffp[i]), fwd_a[i], fwd_b[i])
            ap.abpos, ap.bbpos = trimx, trimy
            ap.diffs = ap.diffs + trimd
            fwd_a[i] = a_pre + fwd_a[i]
            fwd_b[i] = b_pre + fwd_b[i]

        # fshort/rshort double-pass refinement (align.c:1810-1854)
        redo_f, redo_r = [], []
        for i in range(n):
            if i in fallback:
                continue
            ap = apaths[i]
            fshort = (ap.aepos + ap.bepos) - int(anti[i]) < _host.DUB_TRIM
            rshort = int(anti[i]) - (ap.abpos + ap.bbpos) < _host.DUB_TRIM
            if fshort and rshort:
                ap.aepos = ap.abpos = (ap.abpos + ap.aepos) // 2
                ap.bepos = ap.bbpos = (ap.bbpos + ap.bepos) // 2
                fwd_a[i] = []
                fwd_b[i] = []
            elif fshort:
                redo_f.append(i)
            elif rshort:
                redo_r.append(i)

        if redo_f:
            idx = np.array(redo_f, np.int32)
            d2 = np.array([apaths[i].abpos - apaths[i].bbpos for i in redo_f],
                          np.int32)
            a2 = np.array([apaths[i].abpos + apaths[i].bbpos for i in redo_f],
                          np.int32)
            f2 = self._run("fwd", abase[idx], bbase[idx], a2, d2,
                           aoffp[idx], boffp[idx], Aflat, Bflat,
                           sortkey=np.minimum(alen[idx] - (a2 + d2) // 2,
                                              blen[idx] - (a2 - d2) // 2))
            for j, i in enumerate(redo_f):
                if f2.overflow[j]:
                    fallback.add(i)
                    continue
                trimx, trimy, trimd, trimha, trimhb = _reach_select(
                    f2, j, self.spec.reach)
                _, fwd, btr = _host.extract_forward_traces(
                    f2.pool[j], trimha, trimhb, trimx, trimy, trimd,
                    int(a2[j]))
                ap = apaths[i]
                ap.aepos, ap.bepos, ap.diffs = fwd.aepos, fwd.bepos, fwd.diffs
                fwd_a[i] = fwd.trace
                fwd_b[i] = btr

        if redo_r:
            idx = np.array(redo_r, np.int32)
            d2 = np.array([apaths[i].aepos - apaths[i].bepos for i in redo_r],
                          np.int32)
            a2 = np.array([apaths[i].aepos + apaths[i].bepos for i in redo_r],
                          np.int32)
            r2 = self._run("rev", abase[idx], bbase[idx], a2, d2,
                           aoffp[idx], boffp[idx], Aflat, Bflat,
                           sortkey=np.minimum((a2 + d2) // 2,
                                              (a2 - d2) // 2))
            for j, i in enumerate(redo_r):
                if r2.overflow[j]:
                    fallback.add(i)
                    continue
                trimx, trimy, trimd, trimha, trimhb = _reach_select(
                    r2, j, self.spec.reach)
                ap = apaths[i]
                ap.diffs = 0
                fa, fb = [], []
                a_pre, b_pre = _host.extract_reverse_traces(
                    r2.pool[j], trimha, trimhb, trimx, trimy, trimd, TS,
                    int(aoffp[i]), int(boffp[i]), fa, fb)
                ap.abpos, ap.bbpos = trimx, trimy
                ap.diffs = trimd
                fwd_a[i] = a_pre + fa
                fwd_b[i] = b_pre + fb

        for i in range(n):
            if i in fallback:
                self.n_fallback += 1
                a_np = Anp[abase[i]:abase[i] + alen[i]]
                b_np = Bnp[bbase[i]:bbase[i] + blen[i]]
                out[i] = _host.local_alignment(
                    a_np, b_np, self.spec, int(diag[i]), int(diag[i]),
                    int(anti[i]), -1, -1, int(flags[i]))
                continue
            ap = apaths[i]
            bp = _host.PathRec()
            ap.trace = fwd_a[i]
            bp.trace = fwd_b[i]
            _host.finalize_paths(ap, bp, int(flags[i]), int(alen[i]),
                                 int(blen[i]))
            out[i] = (ap, bp)
        return out


def _reach_select(res: WaveResult, i: int, reach: bool):
    """REACH boundary selection (align.c:907-915 / 1561-1569)."""
    if res.morem[i] >= 0 and reach:
        trimy = int(res.morey[i])
        trimx = int(res.morea[i]) - trimy
        trimd = int(res.mored[i])
        trimha = int(res.moreha[i])
        trimhb = int(res.morehb[i])
    else:
        trimy = int(res.trimy[i])
        trimx = int(res.trima[i]) - trimy
        trimd = int(res.trimd[i])
        trimha = int(res.trimha[i])
        trimhb = int(res.trimhb[i])
    return trimx, trimy, trimd, trimha, trimhb

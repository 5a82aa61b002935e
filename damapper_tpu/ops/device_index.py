"""Device-resident k-mer index build + seed matching (jax/XLA).

Device equivalent of Sort_Kmers + Match_Filter's count/merge passes
(reference map.c:447-822, 825-1002, 2889-3208), producing results bit-exact
with the host path (ops.kmers.sort_kmers / ops.seeds.match_seeds):

 * Codes are the same 2-bit big-endian rolling codes, but carried as TWO
   uint32 planes (hi = code >> 32, lo = code & 0xffffffff): JAX runs with
   x64 disabled, so a 2-key
   `lax.sort` over (hi, lo) replaces the reference's 8-bit LSD radix passes
   (map.c:316-444) — the whole index build is one fused XLA program.
 * Window validity (read-boundary sentinels and soft-mask intervals,
   tuple_thread map.c:481-543) comes from a prefix-sum over bad positions:
   a window is valid iff it contains zero sentinel/masked bases.  Invalid
   windows get the all-ones sentinel key, so the sort parks them at the
   end — the same pad-fill trick as map.c:536-543.
 * Seed matching is the two-pass count-then-emit pattern the reference
   already uses (count_thread/merge_thread map.c:881-1002): pass 1 locates
   each a-entry's b-range with a vectorized 2-plane binary search, derives
   the -M hit-count histogram (map.c:2992-3052) and the total hit count;
   pass 2 emits into a bucket-padded buffer via cumsum+searchsorted index
   algebra and sorts by (aread, bread, apos) with a stable 3-key lax.sort.
   Emission order (a-entries in index order x b-entries in index order)
   matches the reference exactly, so stable-sort ties land identically.
 * The sort payload is ONE int32 plane: the k-mer window's global sequence
   position (unique, so it doubles as the stability tie-break key).  The
   (read, rpos) pair the reference carries through its radix passes
   (map.c:231-259) is derived only at hit emission, from a searchsorted
   over the tiny read-offset table — index-build sort traffic drops from
   five operand arrays to three.
 * The complement-strand index never touches the host: comp codes are the
   elementwise reverse-complement of the forward codes (2-bit-group bit
   reversal + XOR), comp positions are the elementwise in-read mirror of
   the forward positions, and window validity is orientation-invariant
   (a mirrored window covers the mirrored base set).  One sequence upload
   serves both orientations, replacing Complement_DB + a second build
   (damapper.c:433-525, map.c:2966-2990).

Shapes are bucketed (next power-of-two style padding) so each distinct
compiled program is reused across blocks.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.memory import device_share
from .kmers import KmerIndex
from .seeds import MAXGRAM, SeedHits, match_limit


def _bucket(n: int, lo: int = 1 << 12) -> int:
    """Pad size n up to a bounded set of compile shapes: powers of two with
    one midpoint each (1.0x and 1.5x), minimum lo."""
    if n <= lo:
        return lo
    p = 1 << (int(n - 1).bit_length() - 1)
    return int(p + p // 2) if n <= p + p // 2 else int(2 * p)


# ---------------------------------------------------------------------------
# index build
# ---------------------------------------------------------------------------


#: positions >= this flag bit are invalid/culled entries (parked after all
#: real entries in their sentinel-key group); real positions stay < 2^30
#: because block sizes are bounded well below 1 Gbp
_POS_INVALID = 1 << 30


@dataclass
class DeviceKmerIndex:
    """Sorted k-mer index resident on device (split-key layout).

    hi/lo/pos are padded device arrays of the same bucketed length; entries
    [n:] are sentinel-keyed padding.  `pos` is the k-mer window's global
    start position in the block's sentinel sequence layout — (read, rpos)
    derive from it and the `boffs` read-offset table on demand."""

    hi: jax.Array      # uint32[cap] sorted composite key, high plane
    lo: jax.Array      # uint32[cap] low plane
    pos: jax.Array     # int32[cap] window global start (sorted payload)
    n: int
    boffs: jax.Array   # int32[rcap] read start offsets (padding: cap-1)
    kmer: int
    rlens: jax.Array | None = None   # int32[rcap] read lengths (pad: 0) —
    #   enables emission-time strand-frame mirroring (comp matching
    #   against a forward index)

    def __len__(self):
        return self.n

    def to_host(self) -> KmerIndex:
        """Materialize as the host KmerIndex (for parity tests and the
        host chain path)."""
        hi = np.asarray(self.hi[: self.n]).astype(np.uint64)
        lo = np.asarray(self.lo[: self.n]).astype(np.uint64)
        pos = np.asarray(self.pos[: self.n])
        boffs = np.asarray(self.boffs)
        read = np.searchsorted(boffs, pos, side="right").astype(np.int32) - 1
        rpos = pos - boffs[np.maximum(read, 0)] + (self.kmer - 1)
        return KmerIndex((hi << np.uint64(32)) | lo, read,
                         rpos.astype(np.int32))


def _rev2bit32(v):
    """Reverse the sixteen 2-bit groups of a uint32 (elementwise)."""
    m2, m4 = jnp.uint32(0x33333333), jnp.uint32(0x0F0F0F0F)
    m8 = jnp.uint32(0x00FF00FF)
    v = ((v & m2) << 2) | ((v >> 2) & m2)
    v = ((v & m4) << 4) | ((v >> 4) & m4)
    v = ((v & m8) << 8) | ((v >> 8) & m8)
    return (v << 16) | (v >> 16)


def _revcomp_codes(hi, lo, kmer: int):
    """Elementwise reverse-complement of split-plane 2k-bit codes.

    The 64-bit code is (hi << 2*klo) | lo with only the low 2k bits used;
    complement = XOR over every 2-bit base, reversal = 2-bit-group bit
    reversal of the 64-bit word followed by a right shift to re-align."""
    klo = min(kmer, 16)
    khi = kmer - klo
    if khi == 0:
        c = lo ^ jnp.uint32((1 << (2 * kmer)) - 1)
        r = _rev2bit32(c)
        return jnp.zeros_like(hi), r >> (32 - 2 * kmer)
    him = jnp.uint32(0xFFFFFFFF if khi == 16 else (1 << (2 * khi)) - 1)
    rhi = _rev2bit32(lo ^ jnp.uint32(0xFFFFFFFF))   # top 32 of rev64
    rlo = _rev2bit32(hi ^ him)                      # low 32 of rev64
    s = 32 - 2 * khi                                # 64 - 2k
    if s:
        new_lo = (rlo >> s) | (rhi << (32 - s))
        new_hi = rhi >> s
    else:
        new_lo, new_hi = rlo, rhi
    return new_hi, new_lo


@functools.partial(jax.jit,
                   static_argnames=("kmer", "suppress", "comp", "tight"))
def _build_index(seq, boffs, eoffs, mask_bad, kmer: int, suppress: int,
                 comp: bool, tight: int | None = None):
    """Jitted index build over a padded sequence array.

    seq:      uint8[L] numeric bases with 4-sentinels (padding is sentinel),
              ALWAYS the forward strand — comp=True derives the
              complement-strand index elementwise (revcomp codes + mirrored
              positions), bit-exact with building over Complement_DB output
    boffs:    int32[R] read start offsets (R = padded read count; padding
              entries repeat L-1)
    eoffs:    int32[R] read end offsets boff+rlen (padding: L-1)
    mask_bad: uint8[L] extra bad positions (soft-mask intervals), or a
              zero-length array when the DB has no mask tracks

    The sort carries (hi, lo, pos): pos is unique, so using it as the
    third sort key IS the stable order, and it parks invalid/culled
    entries (pos |= _POS_INVALID) after every real entry of the same key.
    """
    L = seq.shape[0]
    n = L - kmer + 1
    s = seq.astype(jnp.uint32)
    idx = jnp.arange(n, dtype=jnp.int32)

    # validity: zero bad positions in the window (prefix-sum differencing).
    # Orientation-invariant: the mirrored window covers the mirrored bases.
    bad = (seq >= 4).astype(jnp.int32)
    if mask_bad.shape[0]:
        bad = bad | mask_bad.astype(jnp.int32)
    cum = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(bad)])
    valid = (cum[kmer:kmer + n] - cum[:n]) == 0

    # rolling codes, split into two 32-bit planes
    klo = min(kmer, 16)
    khi = kmer - klo
    lo = jnp.zeros(n, jnp.uint32)
    for x in range(khi, kmer):
        lo = (lo << 2) | lax.dynamic_slice(s, (x,), (n,))
    hi = jnp.zeros(n, jnp.uint32)
    for x in range(khi):
        hi = (hi << 2) | lax.dynamic_slice(s, (x,), (n,))

    if comp:
        hi, lo = _revcomp_codes(hi, lo, kmer)
        # in-read mirror of the window start: x' = boff + end - k - x.
        # boff/end maps by position via value-marked cummax scans (marks
        # are increasing, so cummax holds the current read's value)
        starts = jnp.zeros(L, jnp.int32).at[boffs].max(boffs)
        boff_of = lax.cummax(starts)[:n]
        emarks = jnp.zeros(L, jnp.int32).at[boffs].max(eoffs)
        end_of = lax.cummax(emarks)[:n]
        pos = boff_of + end_of - kmer - idx
    else:
        pos = idx

    sent = jnp.uint32(0xFFFFFFFF)
    hi = jnp.where(valid, hi, sent)
    lo = jnp.where(valid, lo, sent)
    pos = jnp.where(valid, pos, idx | _POS_INVALID)

    # pos is unique: 3-key sort == stable 2-key sort, and real entries
    # (pos < _POS_INVALID) precede invalid ones within a sentinel-code
    # group (the k=32 T^32 collision case, map.c:536-543).
    # tight: the seq cap's bucketed pad (up to 44% at a 140Mb block) is
    # all trailing sentinel rows — already sentinel-keyed with ascending
    # pos, i.e. already in their final sorted position — so the big sort
    # runs on the tight prefix only and the tail is concatenated back.
    def _sorted3(hi, lo, pos):
        if tight is not None and tight < n:
            hs, ls, ps = lax.sort(
                (hi[:tight], lo[:tight], pos[:tight]), num_keys=3)
            return (jnp.concatenate([hs, hi[tight:]]),
                    jnp.concatenate([ls, lo[tight:]]),
                    jnp.concatenate([ps, pos[tight:]]))
        return lax.sort((hi, lo, pos), num_keys=3)

    hi, lo, pos = _sorted3(hi, lo, pos)
    nvalid = jnp.sum(valid.astype(jnp.int32))

    if suppress:
        # drop k-mers with multiplicity >= suppress (strict <, map.c:604):
        # re-key culled entries to the sentinel and re-sort, the device
        # analog of the compress pass (map.c:613-636).  Group sizes come
        # from boundary scans (no scatter)
        gl, gr = _self_ranges(hi, lo)
        counts = gr - gl
        live = jnp.arange(n, dtype=jnp.int32) < nvalid
        keep = (counts < suppress) & live
        hi = jnp.where(keep, hi, sent)
        lo = jnp.where(keep, lo, sent)
        pos = jnp.where(keep, pos, pos | _POS_INVALID)
        # re-keyed entries all live in [:tight] (live implies < nvalid)
        hi, lo, pos = _sorted3(hi, lo, pos)
        nvalid = jnp.sum(keep.astype(jnp.int32))

    # pad back to the bucketed capacity L (kmer-1 sentinel entries): keeps
    # array lengths mesh-divisible for contiguous axis sharding
    pad = L - n
    if pad:
        hi = jnp.concatenate([hi, jnp.full(pad, sent, jnp.uint32)])
        lo = jnp.concatenate([lo, jnp.full(pad, sent, jnp.uint32)])
        pos = jnp.concatenate(
            [pos, (jnp.arange(n, L, dtype=jnp.int32)) | _POS_INVALID])
    return hi, lo, pos, nvalid


def _mask_bad(db, cap: int) -> np.ndarray:
    """uint8[cap]: 1 at soft-masked positions (only when tracks exist)."""
    bad = np.zeros(cap, np.uint8)
    anno, data, _ = next(iter(db.tracks.values()))
    boffs = db.reads["boff"]
    for i in range(db.nreads):
        seg = data[int(anno[i]):int(anno[i + 1])]
        b = int(boffs[i])
        for j in range(0, len(seg), 2):
            bad[b + int(seg[j]):b + int(seg[j + 1])] = 1
    return bad


def pack_seq(seq: np.ndarray, cap: int) -> np.ndarray:
    """Pack numeric bases 4-per-byte (big-endian 2-bit groups), cap-padded.
    Sentinel values (4) lose their identity — the device side re-marks
    every position outside a read interval (see _unpack_seq)."""
    assert cap % 4 == 0
    b = np.zeros(cap, np.uint8)
    b[:len(seq)] = seq
    if __debug__ and len(seq):
        # in-read values >4 (a future ambiguity/track encoding) would be
        # silently corrupted by the 2-bit mask below — sentinels (4) are
        # the only legal non-base value today (~20ms/260Mb, ≪ upload wall)
        mx = int(seq.max())
        if mx > 4:
            raise ValueError(
                f"pack_seq: sequence contains value {mx} > 4; the 2-bit "
                f"packed upload only preserves bases 0..3 and sentinels")
    b &= 3
    return ((b[0::4] << 6) | (b[1::4] << 4) | (b[2::4] << 2)
            | b[3::4]).astype(np.uint8)


# share of device memory the merge join's pow2-padded temps may take
MERGE_SHARE = 0.26

_SHIFTS = np.array([6, 4, 2, 0], np.uint8)    # big-endian 2-bit fields


def _unpack_bases(packed):
    """uint8[4*len(packed)] bases 0..3 of a 2-bit big-endian packing:
    each byte broadcast to its four bases, shifted and masked."""
    return ((packed[:, None] >> jnp.asarray(_SHIFTS)[None, :]) & 3) \
        .reshape(-1)


@jax.jit
def _unpack_seq(packed, starts, ends):
    """uint8[4*len(packed)] numeric bases with 4-sentinels restored at every
    position not inside a [start, end) read interval.  The interval map
    uses the value-marked cummax trick (marks increase with position, so
    cummax holds the covering read's bounds) — no scatter bigger than the
    read count."""
    L = 4 * packed.shape[0]
    seq = _unpack_bases(packed)
    smarks = jnp.zeros(L, jnp.int32).at[starts].max(starts)
    boff_of = lax.cummax(smarks)
    emarks = jnp.zeros(L, jnp.int32).at[starts].max(ends)
    end_of = lax.cummax(emarks)
    idx = jnp.arange(L, dtype=jnp.int32)
    inside = (boff_of <= idx) & (idx < end_of)
    return jnp.where(inside, seq, jnp.uint8(4))


# the single-shot unpack's int32 interval-map transients take ~24 bytes per
# base (boff_of/end_of/inside); past UNPACK_SHARE of device memory the scan
# below bounds them per chunk
UNPACK_SHARE = 0.4
_UNPACK_CL = 1 << 27            # bases per chunk (divides every bucket size)


@functools.partial(jax.jit, static_argnames=("CL",))
def _unpack_seq_scan(packed, starts, ends, CL: int):
    """Chunked _unpack_seq for Gbp-scale buffers: identical output, but the
    interval map's cummax state (the covering read's start/end — reads are
    laid out in increasing order, so running maxima ARE the covering
    bounds) is carried across CL-base chunks by a lax.scan, bounding every
    int32 transient to CL elements instead of L."""
    n = packed.shape[0]
    L = 4 * n
    assert L % CL == 0
    nchunk = L // CL
    pchunks = packed.reshape(nchunk, CL // 4)
    c0s = jnp.arange(nchunk, dtype=jnp.int32) * CL

    def body(carry, xs):
        boff_run, end_run = carry
        pc, c0 = xs
        seq = _unpack_bases(pc)
        in_r = (starts >= c0) & (starts < c0 + CL)
        si = jnp.where(in_r, starts - c0, 0)
        sm = jnp.zeros(CL, jnp.int32).at[si].max(
            jnp.where(in_r, starts, 0))
        em = jnp.zeros(CL, jnp.int32).at[si].max(jnp.where(in_r, ends, 0))
        boff_of = jnp.maximum(lax.cummax(sm), boff_run)
        end_of = jnp.maximum(lax.cummax(em), end_run)
        gidx = c0 + jnp.arange(CL, dtype=jnp.int32)
        inside = (boff_of <= gidx) & (gidx < end_of)
        out = jnp.where(inside, seq, jnp.uint8(4))
        return (boff_of[CL - 1], end_of[CL - 1]), out

    _, ys = lax.scan(body, (jnp.int32(0), jnp.int32(0)), (pchunks, c0s))
    return ys.reshape(L)


def _unpack_single_shot_max() -> int:
    """Most bases the single-shot unpack may take (24 bytes of transients
    per base within UNPACK_SHARE of device memory)."""
    return device_share(UNPACK_SHARE) // 24


def unpack_seq_dev(packed, starts, ends):
    """Dispatch: single-shot unpack below the transient-memory threshold,
    carried-scan unpack above it (same results)."""
    L = 4 * packed.shape[0]
    if L > _unpack_single_shot_max() and L % _UNPACK_CL == 0:
        return _unpack_seq_scan(packed, starts, ends, _UNPACK_CL)
    return _unpack_seq(packed, starts, ends)


def device_upload_seq(db) -> jax.Array:
    """Upload a loaded block's sentinel sequence once, bucket-padded;
    reusable across orientations and k choices of device_sort_kmers.

    The transfer rides 2-bit-packed (4 bases/byte): shipping cap/4 bytes
    and unpacking on device (one cheap fused pass, sentinels restored from
    the read-interval table) moves a quarter of the host-to-device bytes.
    DAMAPPER_PACK_UPLOAD=0 restores the plain uint8 upload."""
    assert db.seq is not None, "db.load_bases() first"
    L = len(db.seq)
    cap = _bucket(L)
    if os.environ.get("DAMAPPER_PACK_UPLOAD", "1") == "0":
        seq = np.full(cap, 4, np.uint8)
        seq[:L] = db.seq
        return jnp.asarray(seq)
    # rcap-padded interval table (pad marks are 0/0 no-ops under .max)
    rcap = _bucket(db.nreads, lo=1 << 8)
    starts = np.zeros(rcap, np.int32)
    ends = np.zeros(rcap, np.int32)
    starts[:db.nreads] = db.reads["boff"]
    ends[:db.nreads] = db.reads["boff"] + db.reads["rlen"]
    return unpack_seq_dev(jnp.asarray(pack_seq(db.seq, cap)),
                          jnp.asarray(starts), jnp.asarray(ends))


def device_sort_kmers(db, kmer: int, suppress: int = 0, comp: bool = False,
                      seq_dev: jax.Array | None = None) -> DeviceKmerIndex:
    """Build the sorted, culled k-mer index of a loaded block on device
    (Sort_Kmers map.c:655 equivalent; bit-exact with kmers.sort_kmers).
    The only O(L) upload is the (forward) sequence; comp=True derives the
    complement-strand index from the same upload — `db` must NOT be
    complement_inplace()'d for it."""
    assert db.seq is not None, "db.load_bases() first"
    assert kmer <= 32
    if seq_dev is None:
        seq_dev = device_upload_seq(db)
    cap = seq_dev.shape[0]
    # read-count padded to a small bucket (repeat a trailing-sentinel
    # position) so compile variants stay bounded
    rcap = _bucket(db.nreads, lo=1 << 8)
    boffs = np.full(rcap, cap - 1, np.int32)
    boffs[:db.nreads] = db.reads["boff"]
    eoffs = np.full(rcap, cap - 1, np.int32)
    eoffs[:db.nreads] = (db.reads["boff"] + db.reads["rlen"]).astype(np.int64)
    mb = _mask_bad(db, cap) if db.tracks else np.zeros(0, np.uint8)

    boffs_dev = jnp.asarray(boffs)
    rlens = np.zeros(rcap, np.int32)
    rlens[:db.nreads] = db.reads["rlen"]
    # tight sort bound: real windows end at the loaded sequence length,
    # everything past it is trailing sentinel pad in final sorted position
    n_windows = cap - kmer + 1
    tight = min(n_windows, _tight_bucket(len(db.seq), n_windows))
    hi, lo, pos, nvalid = _build_index(
        seq_dev, boffs_dev, jnp.asarray(eoffs), jnp.asarray(mb), kmer,
        suppress, comp, tight)
    return DeviceKmerIndex(hi, lo, pos, int(nvalid), boffs_dev, kmer,
                           jnp.asarray(rlens))


# ---------------------------------------------------------------------------
# seed matching
# ---------------------------------------------------------------------------


def _self_ranges(hi, lo):
    """(gl, gr) group spans of every entry of a SORTED 2-plane key array —
    pure scans (cummax/cummin), no gathers or searches."""
    n = hi.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones(1, bool),
                             (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])])
    gl = lax.cummax(jnp.where(first, idx, 0))
    fpos = jnp.where(first, idx, jnp.int32(n))
    rmin = lax.cummin(fpos[::-1])[::-1]          # min first-index >= i
    gr = jnp.concatenate([rmin[1:], jnp.full(1, n, jnp.int32)])
    return gl, gr


def _pow2_above(n: int) -> int:
    return 1 << max(8, int(n - 1).bit_length())


def _tight_bucket(n: int, cap: int) -> int:
    """Static slice bound for the join's b side: the index's padded cap
    can carry up to 50% sentinel rows (a 201M-cap for a 140M-entry ref
    block), and the join pays sort/merge traffic for every one of them.
    1/16-granularity steps bound the pad at ~6% while keeping the set of
    compile shapes small; tiny arrays keep their cap."""
    if cap <= (1 << 22) or n >= cap:
        return cap
    step = 1 << max(20, int(n).bit_length() - 4)
    return min(cap, -(-n // step) * step)


def _bitonic_merge3(hi, lo, pay):
    """Sort a BITONIC 3-plane key sequence ((hi, lo, pay) lexicographic,
    ascending then descending), n a power of two >= 256.

    Tiling-aware: compare-exchange stages run only while the stride
    is >= 128 (every reshape keeps a >=128-wide minor dim).  After the
    stride-128 stage each contiguous 128-block is bitonic and ordered relative to its
    neighbors, so one batched lax.sort along the minor axis finishes."""
    n = hi.shape[0]
    s = n // 2
    while s >= 128:
        r = n // (2 * s)

        def halves(x, r=r, s=s):
            x2 = x.reshape(r, 2 * s)
            return x2[:, :s], x2[:, s:]

        ha, hb = halves(hi)
        la, lb = halves(lo)
        pa, pb = halves(pay)
        swap = ((ha > hb) | ((ha == hb)
                            & ((la > lb) | ((la == lb) & (pa > pb)))))
        hi = jnp.concatenate([jnp.where(swap, hb, ha),
                              jnp.where(swap, ha, hb)], 1).reshape(n)
        lo = jnp.concatenate([jnp.where(swap, lb, la),
                              jnp.where(swap, la, lb)], 1).reshape(n)
        pay = jnp.concatenate([jnp.where(swap, pb, pa),
                               jnp.where(swap, pa, pb)], 1).reshape(n)
        s //= 2
    # is_stable=False: (hi, lo, pay) is a total order wherever order
    # matters (q rows have unique pay; b rows are interchangeable) and a
    # stable sort costs a hidden iota operand + temps at these sizes
    h2, l2, p2 = lax.sort((hi.reshape(-1, 128), lo.reshape(-1, 128),
                           pay.reshape(-1, 128)), dimension=1, num_keys=3,
                          is_stable=False)
    return h2.reshape(n), l2.reshape(n), p2.reshape(n)


def _join_ranges(bhi, blo, bn, qhi, qlo, join: str = "sort",
                 qsplit: int | None = None):
    """(b_lo, b_hi) spans of each query key in a sorted 2-plane b array via
    a sort-merge join: count of b-keys < q (and < q+1) from one combined
    stable sort — O((m+2q) log) sort throughput instead of per-query
    binary-search gather latency (the device analog of merge_thread's linear
    merge, reference map.c:939-1002).

    DAMAPPER_JOIN=bsearch switches to the binary-search join the sharded
    matcher uses (the b side is already sorted, so the combined sort's
    O(m log) re-sorting of it per block is avoidable): 2*log2(m) gathered
    compare rounds over the queries.  Wins when the query side is large
    relative to sort throughput (read-block-scale joins); results are
    identical — padding/sentinel keys clamp to bn on both paths."""
    if join == "bsearch":
        b_lo = jnp.minimum(_searchsorted2(bhi, blo, qhi, qlo, "left"), bn)
        b_hi = jnp.minimum(_searchsorted2(bhi, blo, qhi, qlo, "right"), bn)
        return b_lo, b_hi
    m = bhi.shape[0]
    nq = qhi.shape[0]
    if (join == "merge" and 2 * nq <= 0x7FFFFFFF
            and _pow2_above(nq + m) >= 256
            # the merge materializes ~4 npow-sized i32 temps (16 bytes a
            # row); past MERGE_SHARE of device memory fall back to the
            # combined sort, which needs no pow2 padding
            and 16 * _pow2_above(nq + m) <= device_share(MERGE_SHARE)):
        # both join inputs are ALREADY SORTED (q is the reads' k-mer
        # index, b the reference's) — so the combined sort is really a
        # MERGE: concat(q ascending, pad, b descending) is bitonic under
        # the (hi, lo, qidt) key and one bitonic merge (log n
        # compare-exchange stages) replaces the O(n log^2 n) sort.  b_hi
        # then comes from the same merged-array scans as the "scan" mode.
        FULL = jnp.uint32(0xFFFFFFFF)
        IMAX = jnp.int32(0x7FFFFFFF)
        qid_b = jnp.int32((nq << 1) | 1)
        qid_pad = jnp.int32((nq << 1) + 2)      # even (q-like), > real ids
        if qsplit is not None:
            # q is the CONCAT of two sorted indexes (fwd + revcomp reads,
            # _match_count_pair): pre-merge them so the main input is
            # sorted; the qid payload restores concat order at the end
            np2 = _pow2_above(nq)
            qpad = np2 - nq
            qh_in = jnp.concatenate([qhi[:qsplit],
                                     jnp.full(qpad, FULL, jnp.uint32),
                                     qhi[qsplit:][::-1]])
            ql_in = jnp.concatenate([qlo[:qsplit],
                                     jnp.full(qpad, FULL, jnp.uint32),
                                     qlo[qsplit:][::-1]])
            qid_in = jnp.concatenate([
                jnp.arange(qsplit, dtype=jnp.int32) << 1,
                jnp.full(qpad, qid_pad, jnp.int32),
                (jnp.arange(qsplit, nq, dtype=jnp.int32) << 1)[::-1]])
            qhi, qlo, qids = _bitonic_merge3(qh_in, ql_in, qid_in)
            # the qpad rows sort to the very end (FULL keys, qid above
            # every real id): slicing back to nq keeps exactly the real
            # rows and the main merge's npow at _pow2_above(nq + m)
            qhi, qlo, qids = qhi[:nq], qlo[:nq], qids[:nq]
        else:
            qids = jnp.arange(nq, dtype=jnp.int32) << 1
        npow = _pow2_above(nq + m)
        pad = npow - nq - m
        chi = jnp.concatenate([qhi, jnp.full(pad, FULL, jnp.uint32),
                               bhi[::-1]])
        clo = jnp.concatenate([qlo, jnp.full(pad, FULL, jnp.uint32),
                               blo[::-1]])
        qidt = jnp.concatenate([qids,
                                jnp.full(pad, IMAX, jnp.int32),
                                jnp.full(m, qid_b, jnp.int32)])
        chi, clo, qidt = _bitonic_merge3(chi, clo, qidt)
        tag = qidt & 1
        nb_before = jnp.cumsum(tag) - tag
        first = jnp.concatenate([jnp.ones(1, bool),
                                 (chi[1:] != chi[:-1])
                                 | (clo[1:] != clo[:-1])])
        first_r = jnp.concatenate([jnp.ones(1, bool), first[::-1][:-1]])
        tag_r = tag[::-1]
        excl_r = jnp.cumsum(tag_r) - tag_r
        b_after = lax.cummax(jnp.where(first_r, excl_r, 0))[::-1]
        cbv = ((m + pad) - b_after) - nb_before
        # unstable restore: qidt is unique over the q rows being restored
        _, res_lo, res_cb = lax.sort((qidt, nb_before, cbv), num_keys=1,
                                     is_stable=False)
        b_lo = jnp.minimum(res_lo[:nq], bn)
        b_hi = jnp.minimum(res_lo[:nq] + res_cb[:nq], bn)
        return b_lo, b_hi
    if join == "scan" and 2 * nq <= 0x7FFFFFFF:
        # single-query-image join: b_hi comes from merged-array SCANS, not
        # a q+1 query copy (the "sort" default) and not gathers (the
        # "sortg" variant's 3 nq-sized gathers).  After ONE combined sort of
        # [q, b], for every q row:
        #   b_lo = # b rows strictly before it (equal b keys sort after
        #          equal q rows via the odd tag),
        #   b_hi = # b rows with key <= q = m - (# b rows in key groups
        #          AFTER q's).  The "b rows after my key group" term is a
        #          segment-broadcast-from-first over the REVERSED merged
        #          array: the reversed exclusive cumsum of the b tag is
        #          non-decreasing, so cummax of its value at reversed
        #          group-firsts propagates exactly my group's value (the
        #          same value-marked-cummax trick as _self_ranges/_unpack).
        chi = jnp.concatenate([qhi, bhi])
        clo = jnp.concatenate([qlo, blo])
        qidt = jnp.concatenate([
            jnp.arange(nq, dtype=jnp.int32) << 1,
            jnp.full(m, (nq << 1) | 1, jnp.int32)])
        chi, clo, qidt = lax.sort((chi, clo, qidt), num_keys=3)
        tag = qidt & 1
        nb_before = jnp.cumsum(tag) - tag
        first = jnp.concatenate([jnp.ones(1, bool),
                                 (chi[1:] != chi[:-1])
                                 | (clo[1:] != clo[:-1])])
        # reversed-array group firsts mark ORIGINAL group ends
        first_r = jnp.concatenate([jnp.ones(1, bool), first[::-1][:-1]])
        tag_r = tag[::-1]
        excl_r = jnp.cumsum(tag_r) - tag_r      # b rows strictly behind
        b_after = lax.cummax(jnp.where(first_r, excl_r, 0))[::-1]
        cbv = (m - b_after) - nb_before         # group b-count, >= 0
        _, res_lo, res_cb = lax.sort((qidt, nb_before, cbv), num_keys=1)
        b_lo = jnp.minimum(res_lo[:nq], bn)
        b_hi = jnp.minimum(res_lo[:nq] + res_cb[:nq], bn)
        return b_lo, b_hi
    if join == "sortg" and 2 * nq + 1 <= 0x7FFFFFFF:
        # b_hi from b's OWN group spans instead of a q+1 query copy: only
        # one query image rides the combined sort, so both big sorts move
        # ~29% fewer rows.
        # b_hi = b_lo + |group at b_lo| when the key at b_lo equals q
        # (b_lo is then that group's first entry); all-ones/padding edges
        # collapse into the bn clamp because real entries of the sentinel
        # group are contiguous up to bn.
        idx = jnp.arange(m, dtype=jnp.int32)
        first = jnp.concatenate([jnp.ones(1, bool),
                                 (bhi[1:] != bhi[:-1])
                                 | (blo[1:] != blo[:-1])])
        fpos = jnp.where(first, idx, jnp.int32(m))
        rmin = lax.cummin(fpos[::-1])[::-1]      # min group-start > i
        gr = jnp.concatenate([rmin[1:], jnp.full(1, m, jnp.int32)])
        chi = jnp.concatenate([qhi, bhi])
        clo = jnp.concatenate([qlo, blo])
        qidt = jnp.concatenate([
            jnp.arange(nq, dtype=jnp.int32) << 1,
            jnp.full(m, (nq << 1) | 1, jnp.int32)])
        chi, clo, qidt = lax.sort((chi, clo, qidt), num_keys=3)
        tag = qidt & 1
        nb_before = jnp.cumsum(tag) - tag
        _, res = lax.sort((qidt, nb_before), num_keys=1)
        b_lo = jnp.minimum(res[:nq], bn)
        j = jnp.minimum(b_lo, m - 1)
        eq = (bhi[j] == qhi) & (blo[j] == qlo) & (b_lo < bn)
        b_hi = jnp.where(eq, jnp.minimum(gr[j], bn), b_lo)
        return b_lo, b_hi
    one = jnp.uint32(1)
    q1lo = qlo + one
    q1hi = qhi + (q1lo == 0).astype(jnp.uint32)
    wrapped = (q1hi == 0) & (q1lo == 0)     # q was the all-ones key

    chi = jnp.concatenate([qhi, q1hi, bhi])
    clo = jnp.concatenate([qlo, q1lo, blo])
    if 4 * nq + 1 <= 0x7FFFFFFF:
        # the b/query tag rides the LOW BIT of the slot id so both sorts
        # move one operand less (sort traffic is the whole cost here):
        # queries get even ids in query order, b entries the constant odd
        # maximum — so queries sort BEFORE equal b entries and their slot
        # counts b < q
        qidt = jnp.concatenate([
            jnp.arange(2 * nq, dtype=jnp.int32) << 1,
            jnp.full(m, (2 * nq) << 1 | 1, jnp.int32)])
        chi, clo, qidt = lax.sort((chi, clo, qidt), num_keys=3)
        tag = qidt & 1
        nb_before = jnp.cumsum(tag) - tag
        # bring query slots back into qid order (sort, not scatter):
        # query ids are unique and smaller than every b id
        _, res = lax.sort((qidt, nb_before), num_keys=1)
    else:
        # giant query sets (> ~536M slots): the packed id overflows
        # int32, keep the two-plane tag scheme
        one = jnp.uint32(1)
        tag = jnp.concatenate([jnp.zeros(2 * nq, jnp.uint32),
                               jnp.ones(m, jnp.uint32)])
        qid = jnp.concatenate([jnp.arange(2 * nq, dtype=jnp.int32),
                               jnp.full(m, 2 * nq, jnp.int32)])
        chi, clo, tag, qid = lax.sort((chi, clo, tag, qid), num_keys=3)
        nb_before = (jnp.cumsum(tag.astype(jnp.int32))
                     - tag.astype(jnp.int32))
        isq = (qid < 2 * nq).astype(jnp.uint32)
        _, _, res = lax.sort((one - isq, qid, nb_before), num_keys=2)
    b_lo = jnp.minimum(res[:nq], bn)
    b_hi = jnp.minimum(jnp.where(wrapped, bn, res[nq:2 * nq]), bn)
    return b_lo, b_hi


def _join_mode() -> str:
    """Single-device join strategy, read at call time (a static jit arg, so
    one process can run both for A/B without cache poisoning).

    Default "merge": both join inputs are sorted indexes, so a bitonic
    merge + scan epilogue replaces the combined sort (identical hits).
    "sort"/"scan"/"sortg"/"bsearch" remain selectable; a merge too large
    for MERGE_SHARE of device memory falls back to "sort"."""
    return os.environ.get("DAMAPPER_JOIN", "merge")


def _searchsorted2(khi, klo, qhi, qlo, side: str):
    """Vectorized binary search over a 2-plane sorted key array: a fixed
    log2(n) loop of gathered compares (static shapes).

    The loop is a lax.fori_loop, NOT an unrolled Python loop: unrolled,
    XLA materializes every round's gathered key planes at once (observed
    43.5G of HLO temps at a 100M-query join — an OOM at any block scale);
    rolled, the round's two gathers reuse one buffer."""
    n = khi.shape[0]
    left = side == "left"
    steps = max(1, int(np.ceil(np.log2(max(2, n)))) + 1)

    def body(_, st):
        lo, hi = st
        mid = (lo + hi) >> 1
        mh = khi[mid]
        ml = klo[mid]
        if left:
            less = (mh < qhi) | ((mh == qhi) & (ml < qlo))
        else:
            less = (mh < qhi) | ((mh == qhi) & (ml <= qlo))
        return (jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid))

    lo = jnp.zeros(qhi.shape, jnp.int32)
    hi = jnp.full(qhi.shape, n, jnp.int32)
    lo, hi = lax.fori_loop(0, steps, body, (lo, hi))
    return lo


def _pos_to_read_rpos(p, boffs, kmer: int):
    """(read, rpos) of global window-start positions via the tiny sorted
    read-offset table (a log2(R) binary search, table-resident gathers)."""
    r = jnp.searchsorted(boffs, p, side="right").astype(jnp.int32) - 1
    r = jnp.maximum(r, 0)
    return r, p - boffs[r] + (kmer - 1)


@functools.partial(jax.jit, static_argnames=("use_gram", "join", "btight"))
def _match_count_pair(fhi, flo, fan, chi, clo, can, bhi, blo, bn,
                      use_gram: bool, join: str = "sort",
                      btight: int | None = None):
    """_match_count for BOTH orientations against one b index: the join
    (the expensive combined sort) runs ONCE over the concatenated
    forward+revcomp query keys; group/histogram epilogues stay
    per-orientation.  Saves one b-sized sort per reference block.

    The forward and revcomp query indexes MUST share padded capacity:
    the combined join result is split at nq = fhi.shape[0], so
    differently-bucketed indexes would silently misalign the comp side's
    b-ranges."""
    assert fhi.shape == chi.shape and flo.shape == clo.shape, \
        "fwd/revcomp query indexes must share padded capacity"
    nq = fhi.shape[0]
    if btight is not None:
        # rows past bn are sentinel padding; every join result clamps to
        # bn, so the tight static slice is free precision-wise and cuts
        # the join's sort/merge traffic by the cap's pad fraction
        bhi, blo = bhi[:btight], blo[:btight]
    qhi = jnp.concatenate([fhi, chi])
    qlo = jnp.concatenate([flo, clo])
    b_lo2, b_hi2 = _join_ranges(bhi, blo, bn, qhi, qlo, join,
                                qsplit=nq if join == "merge" else None)

    def _epi(hi, lo, an_, b_lo, b_hi):
        idx = jnp.arange(nq, dtype=jnp.int32)
        live = idx < an_
        cb = jnp.where(live, b_hi - b_lo, 0).astype(jnp.int32)
        gl, gr = _self_ranges(hi, lo)
        first = gl == idx
        ca = gr - gl
        ctf = ca.astype(jnp.float32) * cb.astype(jnp.float32)
        ct = jnp.minimum(ctf, jnp.float32(0x7FFFFF00)).astype(jnp.int32)
        if use_gram:
            selg = first & live & (cb > 0) & (ct < MAXGRAM) & (ct > 0)
            sv = lax.sort(jnp.where(selg, ct, jnp.int32(0x7FFFFFFF)))
            edges = jnp.arange(MAXGRAM + 1, dtype=jnp.int32)
            pos = jnp.searchsorted(sv, edges, side="left").astype(jnp.int32)
            gram = pos[1:] - pos[:-1]
        else:
            gram = jnp.zeros(MAXGRAM, jnp.int32)
        return cb, ct, gram

    fcb, fct, fgram = _epi(fhi, flo, fan, b_lo2[:nq], b_hi2[:nq])
    ccb, cct, cgram = _epi(chi, clo, can, b_lo2[nq:], b_hi2[nq:])
    return (b_lo2[:nq], fcb, fct, fgram), (b_lo2[nq:], ccb, cct, cgram)


@functools.partial(jax.jit, static_argnames=("use_gram", "join", "btight"))
def _match_count(ahi, alo, bhi, blo, an, bn, use_gram: bool,
                 join: str = "sort", btight: int | None = None):
    """Pass 1: per-a-entry b-ranges, per-group totals, hit histogram and
    the total emitted-hit count (before the -M cap)."""
    n = ahi.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    live = idx < an

    if btight is not None:
        bhi, blo = bhi[:btight], blo[:btight]
    b_lo, b_hi = _join_ranges(bhi, blo, bn, ahi, alo, join)
    cb = jnp.where(live, b_hi - b_lo, 0).astype(jnp.int32)

    # group structure over the a index (equal composite keys): spans from
    # boundary scans — no gathers, no scatters
    gl, gr = _self_ranges(ahi, alo)
    first = gl == idx
    ca = gr - gl
    # ca*cb can overflow int32; a float32 product is exact below 2^24 and
    # only ever compared against thresholds <= MAXGRAM, so large values just
    # need to stay large
    ctf = ca.astype(jnp.float32) * cb.astype(jnp.float32)
    ct = jnp.minimum(ctf, jnp.float32(0x7FFFFF00)).astype(jnp.int32)
    # hitgram over groups (first entry of each group only): sort + edge
    # searchsorted instead of a binned scatter-add
    if use_gram:
        sel = first & live & (cb > 0) & (ct < MAXGRAM) & (ct > 0)
        sv = lax.sort(jnp.where(sel, ct, jnp.int32(0x7FFFFFFF)))
        edges = jnp.arange(MAXGRAM + 1, dtype=jnp.int32)
        pos = jnp.searchsorted(sv, edges, side="left").astype(jnp.int32)
        gram = pos[1:] - pos[:-1]
    else:
        gram = jnp.zeros(MAXGRAM, jnp.int32)
    return b_lo, cb, ct, gram


def _avail_budget(mem_limit: int, db_bytes: int, alen: int,
                  blen: int) -> int:
    """The -M memory budget in 16-byte hit units (map.c:2992-3012)."""
    avail = (mem_limit - db_bytes) // 16
    if avail > alen + 2 * blen:
        avail = (avail - alen) // 2
    else:
        avail = avail - (alen + blen)
    return int(avail * .98)


@jax.jit
def _device_limit(gram, avail):
    """First histogram bin whose cumulative j*gram[j] exceeds the budget
    (the match_limit loop, map.c:3013-3052, on device)."""
    j = jnp.arange(MAXGRAM, dtype=jnp.int32)
    tom = jnp.cumsum(j * gram)
    over = tom > avail
    return jnp.where(over.any(), jnp.argmax(over).astype(jnp.int32),
                     jnp.int32(MAXGRAM))


@jax.jit
def _match_emit_prep(cb, ct, limit):
    """Selection mask + per-a-row output offsets + total."""
    sel = (cb > 0) & (ct < limit)
    take = jnp.where(sel, cb, 0)
    cum = jnp.cumsum(take.astype(jnp.int32))
    total = cum[-1]
    return sel, cum, total


@functools.partial(jax.jit, static_argnames=("ncap", "akmer", "bkmer"))
def _match_emit(a_pos, aboffs, b_pos, bboffs, b_lo, cum, ncap: int,
                akmer: int, bkmer: int):
    """Pass 2: emit hits into an ncap-padded buffer and sort by
    (aread, bread, apos), stable.  (read, rpos) derive from the gathered
    window positions only at the emitted rows."""
    t = jnp.arange(ncap, dtype=jnp.int32)
    total = cum[-1]
    # a_row = first row whose inclusive cumsum exceeds t
    a_row = jnp.searchsorted(cum, t, side="right").astype(jnp.int32)
    a_row = jnp.minimum(a_row, cum.shape[0] - 1)
    prev = jnp.where(a_row > 0, cum[jnp.maximum(a_row - 1, 0)], 0)
    b_off = (t - prev).astype(jnp.int32)
    b_row = b_lo[a_row] + b_off

    pad = t >= total
    big = jnp.int32(0x7FFFFFFF)
    ar, ap = _pos_to_read_rpos(a_pos[a_row], aboffs, akmer)
    br, bp = _pos_to_read_rpos(
        b_pos[jnp.minimum(b_row, b_pos.shape[0] - 1)], bboffs, bkmer)
    dg = jnp.where(pad, 0, ap - bp)
    ar = jnp.where(pad, big, ar)
    ap = jnp.where(pad, 0, ap)
    br = jnp.where(pad, 0, br)
    ar, br, ap, dg = lax.sort((ar, br, ap, dg), num_keys=3, is_stable=True)
    # one stacked buffer -> one host pull
    return jnp.stack([ar, br, ap, dg])


@functools.partial(jax.jit, static_argnames=("ncap", "akmer", "bkmer"))
def _match_emit_comp(a_pos, aboffs, a_rlens, b_pos, bboffs, b_rlens,
                     b_lo, cum, ncap: int, akmer: int, bkmer: int):
    """Pass 2, complement frame: the a side is the reads' REVCOMP index
    and the b side the FORWARD reference index, but the emitted hits must
    be bit-identical with matching the forward reads against a
    complemented reference (the reference's orientation loop,
    damapper.c:851-861).  Frame mirror per hit: ap -> rlen+k-2-ap (read
    fwd coords), bp -> clen+k-2-bp (contig comp coords).  Reference tie
    order for equal (ar, br, ap) is ascending comp bp — the forward index
    enumerates it descending, so bp joins the sort as an explicit 4th key
    instead of relying on emission-order stability."""
    t = jnp.arange(ncap, dtype=jnp.int32)
    total = cum[-1]
    a_row = jnp.searchsorted(cum, t, side="right").astype(jnp.int32)
    a_row = jnp.minimum(a_row, cum.shape[0] - 1)
    prev = jnp.where(a_row > 0, cum[jnp.maximum(a_row - 1, 0)], 0)
    b_off = (t - prev).astype(jnp.int32)
    b_row = b_lo[a_row] + b_off

    pad = t >= total
    big = jnp.int32(0x7FFFFFFF)
    ar, ap_rc = _pos_to_read_rpos(a_pos[a_row], aboffs, akmer)
    ap = a_rlens[ar] + (akmer - 2) - ap_rc
    br, bp = _pos_to_read_rpos(
        b_pos[jnp.minimum(b_row, b_pos.shape[0] - 1)], bboffs, bkmer)
    bpc = b_rlens[br] + (bkmer - 2) - bp
    ar = jnp.where(pad, big, ar)
    ap = jnp.where(pad, 0, ap)
    br = jnp.where(pad, 0, br)
    bpc = jnp.where(pad, 0, bpc)
    ar, br, ap, bpc = lax.sort((ar, br, ap, bpc), num_keys=4)
    dg = jnp.where(ar == big, 0, ap - bpc)
    return jnp.stack([ar, br, ap, dg])


def device_match_seeds(aidx: DeviceKmerIndex, bidx: DeviceKmerIndex,
                       mem_limit: int = 0, db_bytes: int = 0,
                       comp_frame: bool = False) -> SeedHits:
    """Intersect two device k-mer indexes; returns host SeedHits bit-exact
    with seeds.match_seeds (Match_Filter passes, map.c:2889-3135).

    comp_frame=True: `aidx` is the reads' revcomp index and `bidx` the
    FORWARD reference index; hits come out in the reference's complement
    frame (identical to matching reads-fwd against a complemented ref
    index) — one reference index build serves both orientations."""
    empty = SeedHits(*(np.zeros(0, np.int32),) * 4)
    if aidx.n == 0 or bidx.n == 0:
        return empty

    b_lo, cb, ct, gram = _match_count(aidx.hi, aidx.lo, bidx.hi, bidx.lo,
                                      jnp.int32(aidx.n), jnp.int32(bidx.n),
                                      mem_limit > 0, _join_mode(),
                                      _tight_bucket(bidx.n,
                                                    bidx.hi.shape[0]))
    if mem_limit > 0:
        avail = _avail_budget(mem_limit, db_bytes, aidx.n, bidx.n)
        limit = _device_limit(gram, jnp.int32(min(max(avail, 0),
                                                  0x7FFFFFFF)))
    else:
        limit = jnp.int32(0x7FFFFFFF)

    sel, cum, total = _match_emit_prep(cb, ct, limit)
    # one small pull for the two host-needed scalars
    tl = np.asarray(jnp.stack([total, limit]))
    total, limit_v = int(tl[0]), int(tl[1])
    if mem_limit > 0 and limit_v <= 1:
        raise MemoryError("Insufficient memory for seed hits; reduce block "
                          "size or raise -M")
    if total == 0:
        return empty
    ncap = _bucket(total)
    if comp_frame:
        packed = np.asarray(_match_emit_comp(
            aidx.pos, aidx.boffs, aidx.rlens, bidx.pos, bidx.boffs,
            bidx.rlens, b_lo, cum, ncap, aidx.kmer, bidx.kmer))
    else:
        packed = np.asarray(_match_emit(aidx.pos, aidx.boffs, bidx.pos,
                                        bidx.boffs, b_lo, cum, ncap,
                                        aidx.kmer, bidx.kmer))
    return SeedHits(packed[0, :total], packed[1, :total],
                    packed[2, :total], packed[3, :total])


def _finish_match(aidx, bidx, b_lo, cb, ct, gram, mem_limit, db_bytes,
                  comp_frame):
    """Shared tail of the matchers: -M limit, emission prep, emit+sort."""
    empty = SeedHits(*(np.zeros(0, np.int32),) * 4)
    if mem_limit > 0:
        avail = _avail_budget(mem_limit, db_bytes, aidx.n, bidx.n)
        limit = _device_limit(gram, jnp.int32(min(max(avail, 0),
                                                  0x7FFFFFFF)))
    else:
        limit = jnp.int32(0x7FFFFFFF)
    sel, cum, total = _match_emit_prep(cb, ct, limit)
    tl = np.asarray(jnp.stack([total, limit]))
    total, limit_v = int(tl[0]), int(tl[1])
    if mem_limit > 0 and limit_v <= 1:
        raise MemoryError("Insufficient memory for seed hits; reduce block "
                          "size or raise -M")
    if total == 0:
        return empty
    ncap = _bucket(total)
    if comp_frame:
        packed = np.asarray(_match_emit_comp(
            aidx.pos, aidx.boffs, aidx.rlens, bidx.pos, bidx.boffs,
            bidx.rlens, b_lo, cum, ncap, aidx.kmer, bidx.kmer))
    else:
        packed = np.asarray(_match_emit(aidx.pos, aidx.boffs, bidx.pos,
                                        bidx.boffs, b_lo, cum, ncap,
                                        aidx.kmer, bidx.kmer))
    return SeedHits(packed[0, :total], packed[1, :total],
                    packed[2, :total], packed[3, :total])


def device_match_seeds_pair(reads_fwd: DeviceKmerIndex,
                            reads_rc: DeviceKmerIndex,
                            ref_idx: DeviceKmerIndex, mem_limit: int = 0,
                            db_bytes: int = 0):
    """Both orientations of Match_Filter against ONE forward reference
    index with a single combined sort-merge join: the reads' forward and
    revcomp query keys ride one _join_ranges pass over the (large)
    reference index.  Returns (hits_fwd, hits_comp), each bit-exact with
    the corresponding device_match_seeds call."""
    empty = SeedHits(*(np.zeros(0, np.int32),) * 4)
    if ref_idx.n == 0 or (reads_fwd.n == 0 and reads_rc.n == 0):
        return empty, empty
    (fb_lo, fcb, fct, fgram), (cb_lo, ccb, cct, cgram) = _match_count_pair(
        reads_fwd.hi, reads_fwd.lo, jnp.int32(reads_fwd.n),
        reads_rc.hi, reads_rc.lo, jnp.int32(reads_rc.n),
        ref_idx.hi, ref_idx.lo, jnp.int32(ref_idx.n), mem_limit > 0,
        _join_mode(),
        _tight_bucket(ref_idx.n, ref_idx.hi.shape[0]))
    hits_f = _finish_match(reads_fwd, ref_idx, fb_lo, fcb, fct, fgram,
                           mem_limit, db_bytes, False)
    hits_c = _finish_match(reads_rc, ref_idx, cb_lo, ccb, cct, cgram,
                           mem_limit, db_bytes, True)
    return hits_f, hits_c


# ---------------------------------------------------------------------------
# multi-chip sharded matching (mesh axes: "dp" = reads/seed data parallel,
# "ref" = reference-index memory sharding)
# ---------------------------------------------------------------------------
#
# The device equivalent of the reference's two scaling axes (SURVEY.md §2.2):
# thread/cluster data-parallelism over a-reads (map.c:2966-2978,
# HPC.damapper.c:359-443) maps to "dp" shards of the reads index; block
# streaming of the reference (damapper.c:835-864) maps to "ref" shards of
# the sorted reference index, with the per-group hit totals merged by a
# psum over "ref" (the collective replacing the coff-cache accumulation,
# map.c:2874-2888).  Emission happens per (dp, ref) device pair; one global
# stable 3-key sort of the gathered, pad-keyed buffers restores the exact
# reference hit order (ties = same a-entry, b-entries ascending across ref
# shards in shard order).


def _mesh_is_multiprocess(mesh) -> bool:
    """True when the mesh spans more than one jax process (multi-host)."""
    pid = jax.process_index()
    return any(d.process_index != pid for d in mesh.devices.flat)


def _global_put(x, sharding):
    """Place host-identical data onto a (possibly cross-process) sharding.

    Single-process: plain device_put.  Multi-process: every rank holds the
    same full copy (the pipeline's host stages are replicated), so each
    process serves its addressable shards from its local copy."""
    if not _mesh_is_multiprocess(sharding.mesh):
        return jax.device_put(x, sharding)
    xh = np.asarray(x)
    return jax.make_array_from_callback(xh.shape, sharding,
                                        lambda idx: xh[idx])


def shard_index(idx: DeviceKmerIndex, mesh, axis: str) -> DeviceKmerIndex:
    """Re-place an index's arrays contiguously sharded over a mesh axis."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    return DeviceKmerIndex(
        _global_put(idx.hi, sh), _global_put(idx.lo, sh),
        _global_put(idx.pos, sh), idx.n,
        _global_put(idx.boffs, rep), idx.kmer,
        None if idx.rlens is None else _global_put(idx.rlens, rep))


_SHARDED_CACHE: dict = {}


def _sharded_fns(mesh):
    """Build (count, middle1, middle2, emit_factory) for a (dp, ref) mesh
    (cached).  middle1/middle2 are the between-collective group math as
    jitted programs with REPLICATED outputs: on a multi-process mesh the
    host may only np.asarray fully-addressable arrays, so every value the
    host consumes is forced to a full replica (a no-op data-wise on a
    single-process mesh, where it was already gathered on pull)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    key = (id(mesh), mesh.shape["dp"], mesh.shape["ref"])
    if key in _SHARDED_CACHE:
        return _SHARDED_CACHE[key]
    ndp = mesh.shape["dp"]
    nref = mesh.shape["ref"]
    # replicated outputs are only NEEDED across processes (the host can
    # np.asarray any single-process array); on one process, forcing
    # replication would all-gather the big emit/count buffers onto every
    # device for nothing, so leave out_shardings to the compiler there
    rep = (NamedSharding(mesh, P()) if _mesh_is_multiprocess(mesh)
           else None)

    def _local_ranges(ahi_l, alo_l, bhi_l, blo_l, bn_l):
        """Per-(dp,ref)-device b-ranges of the local a slice against the
        local b slice.  bn_l: live entries in this b shard (1-elem)."""
        b_lo = _searchsorted2(bhi_l, blo_l, ahi_l, alo_l, "left")
        b_hi = _searchsorted2(bhi_l, blo_l, ahi_l, alo_l, "right")
        b_lo = jnp.minimum(b_lo, bn_l[0])
        b_hi = jnp.minimum(b_hi, bn_l[0])
        return b_lo, (b_hi - b_lo).astype(jnp.int32)

    def count_local(ahi, alo, bhi, blo, bn_l):
        b_lo, cb_l = _local_ranges(ahi, alo, bhi, blo, bn_l)
        cb_g = lax.psum(cb_l, "ref")
        return cb_g, cb_l

    count = jax.jit(jax.shard_map(
        count_local, mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("ref"), P("ref"), P("ref")),
        out_specs=(P("dp"), P(("ref", "dp"))), check_vma=False))

    def _group_sel(cb_g, ahi, alo, an):
        """Group totals + selection mask (the epilogue of _match_count,
        identical math to the unsharded path)."""
        n = ahi.shape[0]
        idx = jnp.arange(n, dtype=jnp.int32)
        live = idx < an
        cb_g = jnp.where(live, cb_g, 0)
        gl, gr = _self_ranges(ahi, alo)
        first = gl == idx
        ca = gr - gl
        ctf = ca.astype(jnp.float32) * cb_g.astype(jnp.float32)
        ct = jnp.minimum(ctf, jnp.float32(0x7FFFFF00)).astype(jnp.int32)
        return cb_g, live, first, ct

    def middle1_fn(cb_g, ahi, alo, an):
        """-M histogram over group totals (replicated output)."""
        cb_g, live, first, ct = _group_sel(cb_g, ahi, alo, an)
        selg = first & live & (cb_g > 0) & (ct < MAXGRAM) & (ct > 0)
        sv = lax.sort(jnp.where(selg, ct, jnp.int32(0x7FFFFFFF)))
        edges = jnp.arange(MAXGRAM + 1, dtype=jnp.int32)
        pos = jnp.searchsorted(sv, edges, side="left").astype(jnp.int32)
        return pos[1:] - pos[:-1]

    def middle2_fn(cb_g, cb_l, ahi, alo, an, limit):
        """Selection mask, total hit count, and the per-(ref,dp) local
        count map — all replicated for host consumption."""
        cb_g, live, first, ct = _group_sel(cb_g, ahi, alo, an)
        sel = (cb_g > 0) & (ct < limit)
        total = jnp.sum(jnp.where(sel, cb_g, 0))
        return sel, total, cb_l

    middle1 = jax.jit(middle1_fn, out_shardings=rep)
    middle2 = jax.jit(middle2_fn, out_shardings=(rep, rep, rep))

    def emit_factory(ncap: int, akmer: int, bkmer: int,
                     comp_frame: bool = False):
        def emit_local(sel, a_pos, aboffs, a_rlens, ahi, alo, bhi, blo,
                       bn_l, b_pos, bboffs, b_rlens):
            # recompute local ranges (cheaper than shipping (nref, n) maps)
            b_lo, cb_l = _local_ranges(ahi, alo, bhi, blo, bn_l)
            take = jnp.where(sel, cb_l, 0)
            cum = jnp.cumsum(take)
            total = cum[-1]
            t = jnp.arange(ncap, dtype=jnp.int32)
            a_row = jnp.searchsorted(cum, t, side="right").astype(jnp.int32)
            a_row = jnp.minimum(a_row, cum.shape[0] - 1)
            prev = jnp.where(a_row > 0, cum[jnp.maximum(a_row - 1, 0)], 0)
            b_off = t - prev
            b_row = b_lo[a_row] + b_off
            pad = t >= total
            big = jnp.int32(0x7FFFFFFF)
            ar, ap = _pos_to_read_rpos(a_pos[a_row], aboffs, akmer)
            bm = jnp.minimum(b_row, b_pos.shape[0] - 1)
            br, bp = _pos_to_read_rpos(b_pos[bm], bboffs, bkmer)
            shard = lax.axis_index("ref").astype(jnp.int32)
            if comp_frame:
                # complement frame against the FORWARD b index: mirror the
                # coordinates (see _match_emit_comp) and INVERT the tie
                # keys — reference order is ascending comp bp, which the
                # forward index enumerates in descending (shard, b_row)
                ap = a_rlens[ar] + (akmer - 2) - ap
                bp = b_rlens[br] + (bkmer - 2) - bp
                nref_ = lax.axis_size("ref")
                tie1 = nref_ - 1 - shard
                tie2 = big - b_row
            else:
                tie1 = shard
                tie2 = b_row
            dg = jnp.where(pad, 0, ap - bp)
            ar = jnp.where(pad, big, ar)
            ap = jnp.where(pad, 0, ap)
            br = jnp.where(pad, 0, br)
            # tie-break planes for the global sort: ties in (aread, bread,
            # apos) are same-a-row hits whose reference order is ascending
            # b_row = (ref shard, local b_row) in shard-major order
            # (mirrored in the complement frame)
            t1 = jnp.where(pad, big, tie1)
            t2 = jnp.where(pad, big, tie2)
            return ar, br, ap, t1, t2, dg

        def emit_sorted(*args):
            ar, br, ap, t1, t2, dg = jax.shard_map(
                emit_local, mesh=mesh,
                in_specs=(P("dp"), P("dp"), P(), P(), P("dp"), P("dp"),
                          P("ref"), P("ref"), P("ref"), P("ref"), P(),
                          P()),
                out_specs=(P(("dp", "ref")),) * 6, check_vma=False)(*args)
            # global stable sort: orders hits AND compacts pads to the end
            ar, br, ap, t1, t2, dg = lax.sort((ar, br, ap, t1, t2, dg),
                                              num_keys=5, is_stable=True)
            return ar, br, ap, dg

        # replicated outputs: the host slices [:total] off each — on a
        # multi-process mesh only a full replica is addressable everywhere
        return jax.jit(emit_sorted, out_shardings=(rep,) * 4)

    fns = (count, middle1, middle2,
           functools.lru_cache(maxsize=None)(emit_factory))
    _SHARDED_CACHE[key] = fns
    return fns


def device_match_seeds_sharded(aidx: DeviceKmerIndex, bidx: DeviceKmerIndex,
                               mesh, mem_limit: int = 0,
                               db_bytes: int = 0,
                               comp_frame: bool = False) -> SeedHits:
    """Sharded Match_Filter: aidx sharded over "dp", bidx over "ref".

    Bit-exact with device_match_seeds / the host path: the -M histogram and
    group caps are computed on psum-merged global counts, and the final
    5-key sort reproduces the reference emission order exactly."""
    empty = SeedHits(*(np.zeros(0, np.int32),) * 4)
    if aidx.n == 0 or bidx.n == 0:
        return empty
    nref = mesh.shape["ref"]
    cap_b = bidx.hi.shape[0]
    # live entries per b shard (pads live in the trailing shards)
    per = cap_b // nref
    bn_l = np.clip(bidx.n - per * np.arange(nref), 0, per).astype(np.int32)

    count, middle1, middle2, emit_factory = _sharded_fns(mesh)
    # bn_l stays a host numpy array: jit shards uncommitted host inputs on
    # any mesh, including one spanning processes (multi-host index shards)
    cb_g, cb_l = count(aidx.hi, aidx.lo, bidx.hi, bidx.lo, bn_l)

    # group-level totals + -M histogram on the psum-merged global counts:
    # identical math to _match_count's epilogue (no-scatter formulation),
    # run as replicated-output jits (host-addressable on every process)
    n = aidx.hi.shape[0]
    an = np.int32(aidx.n)
    if mem_limit > 0:
        gram = np.asarray(middle1(cb_g, aidx.hi, aidx.lo, an))
        limit = match_limit(gram, mem_limit, db_bytes, aidx.n, bidx.n)
    else:
        limit = np.iinfo(np.int32).max

    sel, total, cb_l = middle2(cb_g, cb_l, aidx.hi, aidx.lo, an,
                               np.int32(min(limit, 0x7FFFFFFF)))
    total = int(total)
    if total == 0:
        return empty
    # per-(dp,ref)-device emission capacity: bounded by the largest local
    # total; one bucketed compile per capacity class
    ndp = mesh.shape["dp"]
    # cb_l rows are per-ref-shard over the full a axis; each dp shard takes
    # a contiguous n/ndp slice, so the true per-device total is a slice sum
    per_a = n // ndp
    selv = np.asarray(sel)
    cbl = np.asarray(cb_l).reshape(nref, n)
    max_loc = 0
    for j in range(nref):
        for i in range(ndp):
            s = slice(i * per_a, (i + 1) * per_a)
            max_loc = max(max_loc, int(cbl[j, s][selv[s]].sum()))
    ncap = _bucket(max(1, max_loc))

    emit = emit_factory(ncap, aidx.kmer, bidx.kmer, comp_frame)
    ar, br, ap, dg = emit(sel, aidx.pos, aidx.boffs, aidx.rlens,
                          aidx.hi, aidx.lo, bidx.hi, bidx.lo, bn_l,
                          bidx.pos, bidx.boffs, bidx.rlens)
    ar, br, ap, dg = (np.asarray(x) for x in (ar, br, ap, dg))
    return SeedHits(ar[:total], br[:total], ap[:total], dg[:total])

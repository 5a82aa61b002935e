"""End-to-end golden tests: our mapper's .las vs the reference damapper's.

The reference binary is built from /root/reference and run (through our
LAsort/LAcat shims) on databases we write; our pipeline must reproduce its
final .las record-for-record (all coordinates, flags, diffs and trace points).
"""

import pathlib

import numpy as np
import pytest

from damapper_tpu.io import db as dbio
from damapper_tpu.io import fasta
from damapper_tpu.io import las as lasio
from damapper_tpu.pipeline.mapper import DamapperConfig, run_damapper
from tests import helpers


def make_dataset(tmp_path, seed=7, glen=120_000, ncontigs=4, nreads=25,
                 bsize=70_000, max_len=8000, **simkw):
    rng = np.random.default_rng(seed)
    genome = helpers.sim_genome(rng, glen)
    clen = glen // ncontigs
    entries = [fasta.FastaEntry(f"ctg{i}", genome[i * clen:(i + 1) * clen])
               for i in range(ncontigs)]
    reads = []
    for _ in range(nreads):
        ci = int(rng.integers(0, ncontigs))
        r, *_ = helpers.sim_read(rng, entries[ci].seq,
                                 min_len=2000, max_len=max_len, **simkw)
        reads.append(r)
    dbio.create_dam(str(tmp_path / "ref.dam"), entries, bsize=bsize)
    dbio.create_db(str(tmp_path / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r) for i, r in enumerate(reads)])
    return tmp_path


def diff_las(a: list, b: list) -> str:
    msgs = []
    if len(a) != len(b):
        msgs.append(f"record count {len(a)} vs {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if x.key() != y.key():
            msgs.append(f"first divergence at record {i}:\n"
                        f"  ref : a{x.aread} b{x.bread} f{x.flags:#x} "
                        f"[{x.abpos},{x.aepos}]x[{x.bbpos},{x.bepos}] "
                        f"d{x.diffs} t{list(x.trace)[:12]}\n"
                        f"  ours: a{y.aread} b{y.bread} f{y.flags:#x} "
                        f"[{y.abpos},{y.aepos}]x[{y.bbpos},{y.bepos}] "
                        f"d{y.diffs} t{list(y.trace)[:12]}")
            break
    return "\n".join(msgs)


def run_both(tmp_path, ref_opts, cfg) -> tuple[list, list]:
    golden = helpers.run_reference_damapper(tmp_path, "ref.dam", "reads.db",
                                            ref_opts)
    grecs, gts = lasio.read_las(str(golden))
    ours_a, _ = run_damapper(str(tmp_path / "ref.dam"),
                             str(tmp_path / "reads.db"), cfg,
                             out_dir=str(tmp_path / "ours"))
    orecs, ots = lasio.read_las(ours_a)
    assert gts == ots
    return grecs, orecs


@pytest.fixture()
def dataset(tmp_path):
    (tmp_path / "ours").mkdir()
    return make_dataset(tmp_path)


def test_e2e_default_options(dataset):
    grecs, orecs = run_both(dataset, ["-k20", "-T4"], DamapperConfig())
    assert len(grecs) > 0
    d = diff_las(grecs, orecs)
    assert not d, d


def test_e2e_smallk_suppress(tmp_path):
    (tmp_path / "ours").mkdir()
    make_dataset(tmp_path, seed=11, glen=80_000, ncontigs=2, nreads=15,
                 bsize=50_000)
    grecs, orecs = run_both(tmp_path, ["-k14", "-t40", "-T2"],
                            DamapperConfig(kmer=14, suppress=40))
    assert len(grecs) > 0
    d = diff_las(grecs, orecs)
    assert not d, d


def test_e2e_near_optimal_pile_order(tmp_path):
    (tmp_path / "ours").mkdir()
    make_dataset(tmp_path, seed=13, glen=60_000, ncontigs=2, nreads=12,
                 bsize=40_000)
    grecs, orecs = run_both(tmp_path, ["-k20", "-n.85", "-z"],
                            DamapperConfig(best_tie=.85, map_order=False))
    assert len(grecs) > 0
    d = diff_las(grecs, orecs)
    assert not d, d


def test_e2e_jax_wave_backend(tmp_path):
    """The batched device wave engine must reproduce the reference .las too.

    Dataset kept small: the vmapped wave runs lockstep lanes, which the CPU
    test backend executes serially."""
    (tmp_path / "ours").mkdir()
    make_dataset(tmp_path, seed=7, glen=24_000, ncontigs=2, nreads=6,
                 bsize=14_000, max_len=3500)
    grecs, orecs = run_both(tmp_path, ["-k20", "-T4"],
                            DamapperConfig(wave_backend="jax"))
    assert len(grecs) > 0
    d = diff_las(grecs, orecs)
    assert not d, d


def test_e2e_dual_output(tmp_path):
    """-C: both Y.X.las and X.Y.las must match the reference
    (damapper.c:709-725 C-flag semantics)."""
    (tmp_path / "ours").mkdir()
    make_dataset(tmp_path, seed=17, glen=60_000, ncontigs=2, nreads=10,
                 bsize=40_000)
    golden_a = helpers.run_reference_damapper(tmp_path, "ref.dam",
                                              "reads.db", ["-k20", "-C"])
    golden_b = tmp_path / "ref.reads.las"
    cfg = DamapperConfig(do_b=True)
    ours_a, ours_b = run_damapper(str(tmp_path / "ref.dam"),
                                  str(tmp_path / "reads.db"), cfg,
                                  out_dir=str(tmp_path / "ours"))
    for gp, op in ((golden_a, ours_a), (golden_b, ours_b)):
        grecs, gts = lasio.read_las(str(gp))
        orecs, ots = lasio.read_las(str(op))
        assert gts == ots
        assert len(grecs) > 0
        d = diff_las(grecs, orecs)
        assert not d, f"{gp}: {d}"


def test_e2e_profile_track(tmp_path):
    """-p: the repeat-profile track (.reads.prof.anno/.data) must match the
    reference byte for byte (map.c:3297-3318)."""
    (tmp_path / "ours").mkdir()
    make_dataset(tmp_path, seed=19, glen=60_000, ncontigs=2, nreads=10,
                 bsize=40_000)
    helpers.run_reference_damapper(tmp_path, "ref.dam", "reads.db",
                                   ["-k20", "-p"])
    cfg = DamapperConfig(profile=True)
    run_damapper(str(tmp_path / "ref.dam"), str(tmp_path / "reads.db"),
                 cfg, out_dir=str(tmp_path / "ours"))
    for ext in (".prof.anno", ".prof.data"):
        g = (tmp_path / f".reads{ext}").read_bytes()
        o = (tmp_path / "ours" / f".reads{ext}").read_bytes()
        assert g == o, f"profile track {ext} differs " \
                       f"({len(g)} vs {len(o)} bytes)"


def test_e2e_pallas_wave_backend(tmp_path):
    """The device wave engine must reproduce the reference .las (on the
    CPU test mesh it is the wave kernel's host build)."""
    (tmp_path / "ours").mkdir()
    make_dataset(tmp_path, seed=23, glen=24_000, ncontigs=2, nreads=6,
                 bsize=14_000, max_len=3500)
    grecs, orecs = run_both(tmp_path, ["-k20", "-T4"],
                            DamapperConfig(wave_backend="device"))
    assert len(grecs) > 0
    d = diff_las(grecs, orecs)
    assert not d, d


def test_e2e_chimeric_reads(tmp_path):
    """Chimeric reads (two distant loci joined in one read) must split
    into the same per-segment chains as the reference: exercises the
    reporter's zone machinery (Entwine/zone splitting, BASELINE config-4
    'chimeric chain splitting') rather than single-locus piles."""
    rng = np.random.default_rng(31)
    glen, ncontigs = 120_000, 3
    genome = helpers.sim_genome(rng, glen)
    clen = glen // ncontigs
    entries = [fasta.FastaEntry(f"ctg{i}", genome[i * clen:(i + 1) * clen])
               for i in range(ncontigs)]
    reads = []
    for _ in range(12):
        # two halves from different contigs / distant loci
        ca, cb = rng.choice(ncontigs, size=2, replace=False)
        ra, *_ = helpers.sim_read(rng, entries[int(ca)].seq,
                                  min_len=1500, max_len=3000)
        rb, *_ = helpers.sim_read(rng, entries[int(cb)].seq,
                                  min_len=1500, max_len=3000)
        reads.append(ra + rb)
    dbio.create_dam(str(tmp_path / "ref.dam"), entries, bsize=70_000)
    dbio.create_db(str(tmp_path / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r)
                    for i, r in enumerate(reads)])
    (tmp_path / "ours").mkdir()
    grecs, orecs = run_both(tmp_path, ["-k20", "-T4"], DamapperConfig())
    assert len(grecs) > 0
    # a chimera maps as >1 disjoint chain for the same read
    from collections import Counter
    per_read = Counter(r.aread for r in grecs)
    assert max(per_read.values()) > 1, "dataset failed to produce chimeras"
    d = diff_las(grecs, orecs)
    assert not d, d


def test_e2e_device_index_backend(tmp_path):
    """The device index/matching path (ops.device_index, default on a GPU)
    must reproduce the reference .las end to end."""
    (tmp_path / "ours").mkdir()
    make_dataset(tmp_path, seed=29, glen=60_000, ncontigs=2, nreads=10,
                 bsize=40_000)
    grecs, orecs = run_both(tmp_path, ["-k20", "-T4"],
                            DamapperConfig(index_backend="device"))
    assert len(grecs) > 0
    d = diff_las(grecs, orecs)
    assert not d, d


def test_e2e_device_chain_backend(tmp_path):
    """The batched XLA chain DP (ops.chain_jax, DAMAPPER_CHAIN=device) must
    reproduce the reference .las end to end."""
    (tmp_path / "ours").mkdir()
    make_dataset(tmp_path, seed=37, glen=60_000, ncontigs=2, nreads=10,
                 bsize=40_000)
    grecs, orecs = run_both(tmp_path, ["-k20", "-T4"],
                            DamapperConfig(index_backend="device",
                                           chain_backend="device"))
    assert len(grecs) > 0
    d = diff_las(grecs, orecs)
    assert not d, d


def write_mask_track(dbfile, track, ivals_for):
    """Write a reference-format soft-mask track (.root.track.anno/.data):
    anno header [tracklen, size=0] (size==0 marks MASK_TRACK, Check_Track
    DB.c:1676-1678), int64 byte offsets, int32 interval pairs."""
    db = dbio.DazzDB.open(str(dbfile))
    rlens = db.reads["rlen"]
    n = len(rlens)
    anno = np.zeros(n + 1, np.int64)
    chunks, total = [], 0
    for r in range(n):
        flat = np.asarray([x for iv in ivals_for(r, int(rlens[r]))
                           for x in iv], np.int32)
        anno[r] = 4 * total
        chunks.append(flat)
        total += len(flat)
    anno[n] = 4 * total
    data = np.concatenate(chunks) if chunks else np.zeros(0, np.int32)
    dbio.write_track(db.path, track, anno, data.tobytes(), 0)


def test_e2e_mask_tracks(tmp_path):
    """-m soft masks on BOTH databases, two tracks with overlapping
    intervals (exercises the multi-track union merge damapper.c:253-343
    and the masked-window k-mer extraction map.c:481-543, including the
    native kmer_index.cpp mask branch when available)."""
    (tmp_path / "ours").mkdir()
    make_dataset(tmp_path, seed=29, glen=100_000, ncontigs=2, nreads=18,
                 bsize=60_000)

    def iv1(r, L):
        out = []
        if L >= 4000:
            out.append((L // 5, L // 5 + 400))
            out.append((3 * L // 5, 3 * L // 5 + 250))
        return out

    def iv2(r, L):
        if r % 2 == 0 and L >= 4000:
            return [(L // 5 + 200, L // 5 + 700)]  # overlaps iv1's first
        return []

    for dbf in ("ref.dam", "reads.db"):
        write_mask_track(tmp_path / dbf, "msk1", iv1)
        write_mask_track(tmp_path / dbf, "msk2", iv2)
    grecs, orecs = run_both(tmp_path, ["-k20", "-T2", "-mmsk1", "-mmsk2"],
                            DamapperConfig(masks=["msk1", "msk2"]))
    assert len(grecs) > 0
    d = diff_las(grecs, orecs)
    assert not d, d


def test_e2e_subblock_partitioning(tmp_path, monkeypatch):
    """Internal read-range sub-partitioning of ref blocks (cache-resident
    index sorts) must be invisible in the output: merged per-code counts
    keep block-level -M/MAXGRAM semantics."""
    (tmp_path / "ours").mkdir()
    make_dataset(tmp_path, seed=31, glen=120_000, ncontigs=4, nreads=20)
    monkeypatch.setenv("DAMAPPER_SUBBLOCK", "9000")   # many partitions
    grecs, orecs = run_both(tmp_path, ["-k20", "-T2"], DamapperConfig())
    assert len(grecs) > 0
    d = diff_las(grecs, orecs)
    assert not d, d


def test_e2e_ref_index_cache_multiblock(tmp_path):
    """The process-level device ref-index cache (mapper._ref_index_cache)
    must leave multi-read-block output identical to a cache-off run, with
    the cache actually hit on the second block (damapper.c's per-job
    rebuild of the same reference index, eliminated in-process)."""
    from damapper_tpu.pipeline import mapper as mp

    make_dataset(tmp_path, seed=43, glen=90_000, ncontigs=3, nreads=24,
                 bsize=60_000)
    # re-create the reads DB split into 2 blocks
    pathlib.Path(tmp_path / "reads.db").unlink()
    rng = np.random.default_rng(43)
    genome = helpers.sim_genome(rng, 90_000)
    clen = 30_000
    entries = [fasta.FastaEntry(f"ctg{i}", genome[i * clen:(i + 1) * clen])
               for i in range(3)]
    reads = []
    for _ in range(24):
        ci = int(rng.integers(0, 3))
        r, *_ = helpers.sim_read(rng, entries[ci].seq,
                                 min_len=2000, max_len=8000)
        reads.append(r)
    dbio.create_db(str(tmp_path / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r)
                    for i, r in enumerate(reads)], bsize=60_000)
    stub = dbio.read_stub(str(tmp_path / "reads.db"))
    assert stub.nblocks >= 2

    def run_all(sub, cache):
        import os
        os.environ["DAMAPPER_REFCACHE"] = cache
        mp._ref_index_cache.clear()
        mp._ref_index_cache_bytes[0] = 0
        out = tmp_path / sub
        out.mkdir(exist_ok=True)
        try:
            return [run_damapper(str(tmp_path / "ref.dam"),
                                 str(tmp_path / f"reads.{b}"),
                                 DamapperConfig(index_backend="device",
                                                mesh=None),
                                 out_dir=str(out))[0]
                    for b in range(1, stub.nblocks + 1)]
        finally:
            os.environ.pop("DAMAPPER_REFCACHE", None)

    plain = run_all("nocache", "0")
    cached = run_all("cache", "1")
    assert len(mp._ref_index_cache) >= 1     # resident after the run
    for x, y in zip(plain, cached):
        a, ta = lasio.read_las(x)
        b, tb = lasio.read_las(y)
        assert ta == tb
        d = diff_las(a, b)
        assert not d, d


def test_e2e_ref_cache_busts_on_mask_change(tmp_path):
    """Regenerating a mask track between jobs in one process must bust the
    ref-index cache (the reference re-reads tracks per invocation,
    damapper.c:352-388): the cache key folds in the mask files' mtimes."""
    import os

    from damapper_tpu.pipeline import mapper as mp

    make_dataset(tmp_path, seed=47, glen=60_000, ncontigs=2, nreads=10,
                 bsize=70_000)

    def iv(r, L):
        return [(L // 4, L // 4 + 300)] if L >= 2000 else []

    def iv_wide(r, L):
        return [(L // 4, L // 4 + 2000)] if L >= 4000 else []

    write_mask_track(tmp_path / "ref.dam", "msk", iv)
    write_mask_track(tmp_path / "reads.db", "msk", iv)
    cfg = DamapperConfig(masks=["msk"], index_backend="device", mesh=None)

    os.environ["DAMAPPER_REFCACHE"] = "1"
    mp._ref_index_cache.clear()
    mp._ref_index_cache_bytes[0] = 0
    out1 = tmp_path / "o1"
    out2 = tmp_path / "o2"
    out1.mkdir(), out2.mkdir()
    try:
        run_damapper(str(tmp_path / "ref.dam"), str(tmp_path / "reads.db"),
                     cfg, out_dir=str(out1))
        keys1 = set(mp._ref_index_cache)
        assert keys1, "device ref index should have been cached"
        # regenerate the ref mask with different intervals; force a
        # different mtime even on coarse-resolution filesystems
        write_mask_track(tmp_path / "ref.dam", "msk", iv_wide)
        annop = tmp_path / ".ref.msk.anno"
        st = annop.stat()
        os.utime(annop, (st.st_atime, st.st_mtime + 2))
        run_damapper(str(tmp_path / "ref.dam"), str(tmp_path / "reads.db"),
                     cfg, out_dir=str(out2))
        keys2 = set(mp._ref_index_cache)
        assert keys2 - keys1, (
            "changed mask track must produce a NEW cache key (stale index "
            "would be served otherwise)")
    finally:
        os.environ.pop("DAMAPPER_REFCACHE", None)
        mp._ref_index_cache.clear()
        mp._ref_index_cache_bytes[0] = 0

"""End-to-end mapper: the damapper CLI equivalent (reference damapper.c).

Orchestrates: open reads block -> k-mer index -> for each reference block
(forward and complemented): k-mer index + seed match + chain accumulation ->
reporter over the full reference -> sorted .las output (+ -C dual output,
-p repeat profile track).

The external LAsort/LAcat/LAmerge post-pass of the reference (damapper.c:
882-911) is replaced by the in-process chain-preserving sort of
damapper_tpu.io.las.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io import db as dbio
from ..io import las as lasio
from ..io.tracks import merge_mask_tracks
from ..ops.chain import ChainState
from ..ops.kmers import sort_kmers, sort_kmers_partitioned
from ..ops.seeds import match_seeds, match_seeds_multi
from ..ops.spec import new_align_spec
from ..utils.memory import device_share, physical_memory
from .reporter import Reporter


def _auto_mesh():
    """(dp, ref) mesh (None when single-chip): "dp" carries the reference's
    thread/cluster read parallelism, "ref" shards the reference k-mer index
    (SURVEY.md §2.2).

    Under jax.distributed the mesh is LOCAL to this rank by default — in
    per-rank job-ownership mode (parallel.launch) ranks run different
    blocks, so cross-rank collectives would deadlock.  DAMAPPER_COOP=1
    (set by `launch --global-index`) opts into the cooperative global mesh
    whose "ref" axis shards the index across the hosts."""
    import jax
    coop = os.environ.get("DAMAPPER_COOP") == "1"
    devs = jax.devices() if coop else jax.local_devices()
    if len(devs) > 1:
        from ..parallel.mesh import make_mesh
        return make_mesh(len(devs), devices=devs)
    return None


def _platform() -> str:
    import jax
    plat = jax.devices()[0].platform
    if plat not in ("cpu", "gpu"):
        raise RuntimeError(f"unsupported JAX platform {plat!r}")
    return plat


def _auto_backend() -> str:
    """Pick the wave backend: the device engine on a GPU (the wave kernel),
    the host oracle on the CPU.  Override with DAMAPPER_WAVE
    (oracle | jax | device)."""
    return "device" if _platform() == "gpu" else "oracle"


def _auto_index() -> str:
    """Pick the index/matching backend: device (ops.device_index) on a GPU,
    host C++/numpy on the CPU.  Override with DAMAPPER_INDEX
    (host | device)."""
    return "device" if _platform() == "gpu" else "host"


def read_block(path: str, masks: list[str], kmer: int) -> dbio.DazzDB:
    """Open+trim+load a DB/DAM block with mask tracks (read_DB
    damapper.c:345-415)."""
    db = dbio.DazzDB.open(path)
    for m in masks:
        dbio.open_mask_track(db, m)
    db.trim()
    if len(db.tracks) > 1:
        merge_mask_tracks(db)
    if db.cutoff < kmer:
        if (db.reads["rlen"] < kmer).any():
            raise ValueError(
                f"Block {path} contains reads < {kmer}bp long!  Run DBsplit "
                f"-x{kmer}")
    db.load_bases()
    return db


class DamapperConfig:
    def __init__(self, kmer=20, suppress=0, mem_limit=None, ave_error=.85,
                 spacing=100, best_tie=1.0, masks=(), verbose=False,
                 profile=False, do_a=True, do_b=False, map_order=True,
                 wave_backend=None, mesh="auto", index_backend=None,
                 chain_backend=None):
        self.kmer = kmer
        self.suppress = suppress
        self.mem_limit = physical_memory() if mem_limit is None else mem_limit
        self.ave_error = ave_error
        self.spacing = spacing
        self.best_tie = best_tie
        self.masks = list(masks)
        self.verbose = verbose
        self.profile = profile
        self.do_a = do_a
        self.do_b = do_b
        self.map_order = map_order
        if wave_backend is None:
            wave_backend = os.environ.get("DAMAPPER_WAVE") or _auto_backend()
        self.wave_backend = wave_backend
        if index_backend is None:
            index_backend = os.environ.get("DAMAPPER_INDEX") or _auto_index()
        self.index_backend = index_backend
        if chain_backend is None:
            # host by default everywhere: the native sweep is ~linear in
            # hits and never the hot stage; the device sweep exists for
            # scale-out and is parity-tested
            chain_backend = os.environ.get("DAMAPPER_CHAIN", "host")
        self.chain_backend = chain_backend
        self.mesh = mesh


# Device-resident reference-index cache across run_damapper calls: mapping
# many read blocks against one reference (the reference's per-block HPC job
# layout, HPC.damapper.c job loop) rebuilds the SAME ref-block index each
# call.  Keyed by (block file path, mtime, k, -t, masks); single-device
# path only (the sharded index is mesh-bound).  Bounded by total payload
# bytes — DAMAPPER_REFCACHE=0 disables.  The budget is REFCACHE_SHARE of
# device memory: while the NEXT block builds, a cached entry coexists with
# the new index AND the join temps (about 4x an index), so a larger cache
# would crowd them out.
REFCACHE_SHARE = 0.16
_ref_index_cache: dict = {}
_ref_index_cache_bytes = [0]


def _ref_cache_get(key):
    if os.environ.get("DAMAPPER_REFCACHE", "1") == "0":
        return None
    ent = _ref_index_cache.get(key)
    if ent is not None:
        _ref_index_cache[key] = _ref_index_cache.pop(key)  # LRU touch
        return ent[0]
    return None


def _ref_cache_put(key, aindex):
    if os.environ.get("DAMAPPER_REFCACHE", "1") == "0":
        return
    arrs = [aindex.hi, aindex.lo, aindex.pos, aindex.boffs]
    if aindex.rlens is not None:
        arrs.append(aindex.rlens)
    nbytes = sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in arrs)
    budget = device_share(REFCACHE_SHARE)
    if nbytes > budget:
        return
    while _ref_index_cache and _ref_index_cache_bytes[0] + nbytes > budget:
        oldest = next(iter(_ref_index_cache))     # LRU: insertion-ordered
        _, old_bytes = _ref_index_cache.pop(oldest)
        _ref_index_cache_bytes[0] -= old_bytes
    _ref_index_cache[key] = (aindex, nbytes)
    _ref_index_cache_bytes[0] += nbytes


def run_damapper(ref_path: str, reads_path: str, cfg: DamapperConfig,
                 out_dir: str = "."):
    """Map one reads DB/block against a reference DAM.  Returns
    (a_las_path, b_las_path or None)."""
    pwd, aroot, isdam = dbio._split_db_path(ref_path)
    aroot_stub, _ = dbio._strip_part(aroot)
    stubp = os.path.join(pwd, aroot_stub + (".dam" if isdam else ".db"))
    if not os.path.exists(stubp):
        other = os.path.join(pwd, aroot_stub + (".db" if isdam else ".dam"))
        if os.path.exists(other):
            stubp = other
        else:
            raise FileNotFoundError(f"Could not open database {ref_path}")
    stub = dbio.read_stub(stubp)
    nblocks = stub.nblocks
    if nblocks == 0:
        raise ValueError(f"DB {aroot_stub} has not been partitioned")

    # base frequencies come from the reference .idx header (damapper.c:788-796)
    with open(os.path.join(pwd, "." + aroot_stub + ".idx"), "rb") as fp:
        hdr = np.frombuffer(fp.read(dbio.HEADER_DTYPE.itemsize),
                            dbio.HEADER_DTYPE)[0]
    spec = new_align_spec(cfg.ave_error, cfg.spacing, np.array(hdr["freq"]),
                          reach=True)

    bpwd, broot, _ = dbio._split_db_path(reads_path)

    mesh = cfg.mesh
    if mesh == "auto":
        mesh = _auto_mesh()
    # a mesh spanning jax processes = multi-host cooperative mode: every
    # rank executes the same (replicated) host pipeline, the reference
    # index is sharded across hosts, and only rank 0 writes output files
    multiproc = False
    if mesh is not None:
        from ..ops.device_index import _mesh_is_multiprocess
        multiproc = _mesh_is_multiprocess(mesh)

    use_device_index = cfg.index_backend == "device"
    # dp x ref sharded matching: reads index sharded over "dp", each ref
    # block's index over "ref" (the real-pipeline multi-chip path)
    sharded_ix = (use_device_index and mesh is not None
                  and "ref" in getattr(mesh, "axis_names", ())
                  and "dp" in getattr(mesh, "axis_names", ()))
    import time as _time
    times = {"load": 0., "index": 0., "match": 0., "chain": 0., "align": 0.}
    _t = _time.time()
    reads_db = read_block(reads_path, cfg.masks, cfg.kmer)
    times["load"] += _time.time() - _t
    _t = _time.time()
    if use_device_index:
        from ..ops.device_index import (device_match_seeds_pair,
                                        device_match_seeds_sharded,
                                        device_sort_kmers,
                                        device_upload_seq, shard_index)
        reads_seq_dev = device_upload_seq(reads_db)   # one (packed) upload
        bindex = device_sort_kmers(reads_db, cfg.kmer, cfg.suppress,
                                   seq_dev=reads_seq_dev)
        # the reads' revcomp index (one-time) lets BOTH orientations match
        # against a single forward reference index per block — the comp
        # ref build (one full-block sort per block) disappears; hits stay
        # bit-identical via emission-time frame mirroring
        bindex_rc = device_sort_kmers(reads_db, cfg.kmer, cfg.suppress,
                                      comp=True, seq_dev=reads_seq_dev)
        del reads_seq_dev
        if sharded_ix:
            bindex = shard_index(bindex, mesh, "dp")
            bindex_rc = shard_index(bindex_rc, mesh, "dp")
    else:
        bindex = sort_kmers(reads_db, cfg.kmer, cfg.suppress)
    times["index"] += _time.time() - _t
    if cfg.verbose:
        # stage counters mirroring the reference -v (map.c:692-697,792-799)
        print(f"\n   Kmer count = {len(bindex):,}\n"
              f"   Index occupies {len(bindex) / 67108864:.2f}Gb "
              f"({broot})", file=sys.stderr)

    state = ChainState(reads_db.nreads, cfg.kmer, profile=cfg.profile,
                       rlens=reads_db.reads["rlen"], spacing=cfg.spacing)

    # ref-index builds recycle their buffers: each aindex is dead once its
    # hits are chained, so the next build reuses the warm pages
    kscratch: dict = {}
    cache_hits = cache_builds = 0
    for k in range(1, nblocks + 1):
        blk_path = os.path.join(pwd, f"{aroot_stub}.{k}"
                                + (".dam" if isdam else ".db"))
        _t = _time.time()
        ref_blk = read_block(blk_path, cfg.masks, cfg.kmer)
        times["load"] += _time.time() - _t
        bstart = ref_blk.tfirst

        # sub-partition large blocks so each index sort stays cache-resident
        # (bit-exact: merged per-code counts keep block-level -M/MAXGRAM
        # semantics; disabled under -t, whose culling is per-block index)
        sub_bases = int(os.environ.get("DAMAPPER_SUBBLOCK", 24_000_000))
        use_sub = (sub_bases > 0 and cfg.suppress == 0
                   and ref_blk.totlen > 2 * sub_bases)

        # one upload serves both orientations (the comp index derives
        # elementwise on device; no Complement_DB pass, damapper.c:433-525)
        rkey = None
        cached_aindex = None
        if use_device_index and not sharded_ix:
            # block paths are virtual (stub+.idx encode the blocks):
            # key on the stub file's identity + the block number.  The
            # index also depends on the sequence payload (.bps) and every
            # mask track's files — the reference re-reads all of these per
            # invocation (damapper.c:352-388), so a track regenerated
            # between jobs in one process must bust the cache.
            dep_mtimes = [os.path.getmtime(stubp)]
            bpsp = os.path.join(pwd, "." + aroot_stub + ".bps")
            if os.path.exists(bpsp):
                dep_mtimes.append(os.path.getmtime(bpsp))
            for m in cfg.masks:
                for p in dbio.track_paths(
                        os.path.join(pwd, "." + aroot_stub), k, m):
                    dep_mtimes.append(os.path.getmtime(p)
                                      if os.path.exists(p) else -1.0)
            rkey = (os.path.abspath(stubp), tuple(dep_mtimes), k,
                    cfg.kmer, cfg.suppress, tuple(cfg.masks))
            cached_aindex = _ref_cache_get(rkey)
        ref_seq_dev = (device_upload_seq(ref_blk)
                       if use_device_index and cached_aindex is None
                       else None)
        for comp in (0, 1):
            if comp and not use_device_index:
                ref_blk.complement_inplace()
            db_bytes = reads_db.sizeof() + ref_blk.sizeof()
            _t = _time.time()
            if use_device_index:
                if comp == 0:
                    if cached_aindex is not None:
                        cache_hits += 1
                        aindex = cached_aindex
                    else:
                        cache_builds += 1
                        aindex = device_sort_kmers(
                            ref_blk, cfg.kmer, cfg.suppress,
                            seq_dev=ref_seq_dev)
                    if sharded_ix:
                        aindex = shard_index(aindex, mesh, "ref")
                    elif rkey is not None and cached_aindex is None:
                        _ref_cache_put(rkey, aindex)
                # comp == 1 reuses the forward aindex: the reads' revcomp
                # index provides the orientation (damapper.c:851-861's
                # complement pass without the second Sort_Kmers)
                times["index"] += _time.time() - _t
                _t = _time.time()
                if sharded_ix:
                    hits = device_match_seeds_sharded(
                        bindex_rc if comp else bindex, aindex, mesh,
                        cfg.mem_limit, db_bytes, comp_frame=bool(comp))
                elif comp == 0:
                    # one combined join serves both orientations; the comp
                    # hits wait for the comp pass of the loop
                    hits, pending_cmp = device_match_seeds_pair(
                        bindex, bindex_rc, aindex, cfg.mem_limit,
                        db_bytes)
                else:
                    hits = pending_cmp
            elif use_sub:
                subs = sort_kmers_partitioned(ref_blk, cfg.kmer, sub_bases,
                                              kscratch)
                aindex = None
                times["index"] += _time.time() - _t
                _t = _time.time()
                hits = match_seeds_multi(bindex, subs, cfg.mem_limit,
                                         db_bytes)
            else:
                aindex = sort_kmers(ref_blk, cfg.kmer, cfg.suppress,
                                    scratch=kscratch)
                times["index"] += _time.time() - _t
                _t = _time.time()
                hits = match_seeds(bindex, aindex, cfg.mem_limit, db_bytes)
            times["match"] += _time.time() - _t
            if cfg.verbose:
                nidx = (sum(len(i) for i, _ in subs) if aindex is None
                        else len(aindex))
                print(f"   Block {k} comp={comp}: index = {nidx:,} "
                      f"kmers, hit count = {len(hits):,}", file=sys.stderr)
            before = sum(len(c) for c in state.cands)
            _t = _time.time()
            state.process_hits(hits, bstart, comp,
                               device=cfg.chain_backend == "device")
            times["chain"] += _time.time() - _t
            if cfg.verbose:
                # candidate counters (map.c:3184-3208 epilogue)
                tfilt = sum(len(c) for c in state.cands)
                atot = max(1, reads_db.totlen)
                btot = max(1, ref_blk.totlen)
                print(f"     {len(hits):,} {cfg.kmer}-mers "
                      f"({len(hits) / atot / btot:e} of matrix)\n"
                      f"     {tfilt - before:,} candidates added\n"
                      f"     {tfilt:,} candidates "
                      f"({tfilt / atot / btot:e} of matrix)",
                      file=sys.stderr)

    # free the last ref block's device buffers before the align stage: at
    # Gbp scale the align upload (full-reference sequence memory) must not
    # coexist with a ~3GB dead block index (uncached entries only — a
    # cached index intentionally stays resident for the next job)
    if use_device_index:
        if cached_aindex is None and rkey is not None:
            ent = _ref_index_cache.get(rkey)
            if ent is None or ent[0] is not aindex:
                aindex = None
        elif rkey is None:
            aindex = None
        ref_seq_dev = None
        bindex = bindex_rc = None    # reads indexes are dead too

    if nblocks == 1:
        # block 1 IS the full DB: un-complement it (the orientation loop
        # left it reversed — host index path only; the device comp index
        # never touches the host copy) instead of re-decoding the .bps
        if not use_device_index:
            ref_blk.complement_inplace()
        ref_full = ref_blk
    else:
        ref_full = read_block(os.path.join(pwd, aroot_stub
                                           + (".dam" if isdam else ".db")),
                              [], cfg.kmer)

    engine = None
    if cfg.wave_backend in ("jax", "device"):
        # on a mesh spanning processes (multi-host index sharding) the wave
        # stays process-local: host stages are replicated per rank, so lane
        # batches are identical everywhere and dp-sharding them across hosts
        # would only add DCN traffic for work every rank still consumes
        wave_mesh = None if multiproc else mesh
        if cfg.wave_backend == "device":
            from ..ops.wave_kernel import KernelWaveEngine
            engine = KernelWaveEngine(spec, mesh=wave_mesh)
        else:
            from ..ops.wave_jax import WaveEngine
            engine = WaveEngine(spec, mesh=wave_mesh)
    rep = Reporter(spec, cfg.kmer, cfg.spacing, cfg.best_tie,
                   do_a=cfg.do_a, do_b=cfg.do_b, engine=engine)
    profile_out = [] if cfg.profile else None
    _t = _time.time()
    a_recs, b_recs = rep.run(reads_db, ref_full, state,
                             astart=reads_db.tfirst, profile_out=profile_out)
    times["align"] = _time.time() - _t
    if cfg.verbose:
        print(f"      {len(a_recs):,} mapped segments", file=sys.stderr)
        print("      stage seconds: " + "  ".join(
            f"{k}={v:.2f}" for k, v in times.items()), file=sys.stderr)
        if engine is not None:
            # wave-engine telemetry: a silent drift to the host-oracle
            # fallback would destroy device perf while keeping output
            # identical
            ndev = engine.n_total - engine.n_fallback - engine.n_hostmin
            print(f"      wave lanes: {engine.n_total:,} total, "
                  f"{ndev:,} device, {engine.n_fallback:,} overflow-fallback, "
                  f"{engine.n_hostmin:,} tiny-round host",
                  file=sys.stderr)

    # multi-host cooperative mode: all ranks computed identical records;
    # rank 0's copy is canonical, other ranks skip the (racy) file writes
    rank0 = True
    if multiproc:
        import jax as _jax
        rank0 = _jax.process_index() == 0

    a_path = b_path = None
    if cfg.do_a:
        a_recs = lasio.sort_las(a_recs, cfg.map_order)
        a_path = os.path.join(out_dir, f"{broot}.{aroot}.las")
        if rank0:
            lasio.write_las(a_path, a_recs, cfg.spacing)
    if cfg.do_b:
        b_recs = lasio.sort_las(b_recs, cfg.map_order)
        b_path = os.path.join(out_dir, f"{aroot}.{broot}.las")
        if rank0:
            lasio.write_las(b_path, b_recs, cfg.spacing)

    if cfg.profile and rank0:
        anno = np.zeros(reads_db.nreads + 1, np.int64)
        data = bytearray()
        for i, logv in enumerate(profile_out):
            anno[i] = len(data)
            data += logv.tobytes()
        anno[reads_db.nreads] = len(data)
        dbio.write_track(os.path.join(out_dir, "." + broot), "prof",
                         anno, bytes(data), size=8)

    # run telemetry for benchmarks (stage seconds + wave-DP work): the
    # cell-updates metric is waves x band-capacity, the batched analog of
    # the reference's WAVE_STATS counters (align.c:297-312)
    global LAST_STATS
    LAST_STATS = dict(times=dict(times),
                      ref_index_cache_hits=cache_hits,
                      ref_index_builds=cache_builds,
                      total_waves=getattr(engine, "total_waves", 0),
                      band_cap=getattr(engine, "W", 0),
                      cell_updates=(getattr(engine, "total_waves", 0)
                                    * getattr(engine, "W", 0)),
                      n_fallback=getattr(engine, "n_fallback", 0),
                      n_hostmin=getattr(engine, "n_hostmin", 0),
                      n_lanes=getattr(engine, "n_total", 0),
                      # align-stage split: device kernel+pull wall vs the
                      # host side (trace extraction, refinement, fallback)
                      align_device_s=round(getattr(engine, "t_run", 0.), 2),
                      align_host_s=round(
                          max(0., getattr(engine, "t_batch", 0.)
                              - getattr(engine, "t_run", 0.)), 2))
    return a_path, b_path


LAST_STATS: dict = {}


def expand_db_block_arg(arg: str) -> list[str]:
    """'@' block-range expansion of a DB/DAM argument (Parse_Block_DB_Arg
    DB.c:2822-2923): 'root.@' covers every block, 'root.@f' blocks f..n,
    'root.@f-l' the explicit range; a plain name passes through."""
    import re

    m = re.search(r"@(\d+)?(?:-(\d+))?$", arg)
    if not m:
        return [arg]
    if arg.count("@") > 1:
        raise ValueError(f"Two or more occurrences of @-sign in source "
                         f"name '{arg}'")
    base = arg[:m.start()].rstrip(".")
    first = int(m.group(1)) if m.group(1) else 1
    last = int(m.group(2)) if m.group(2) else None
    if first < 1:
        raise ValueError(f"Integer following @-sign is less than 1 in "
                         f"source name '{arg}'")
    if last is not None and last < first:
        raise ValueError(f"2nd integer is less than 1st integer in source "
                         f"name '{arg}'")
    if last is None:
        pwd, root, isdam = dbio._split_db_path(base)
        stubp = os.path.join(pwd, root + (".dam" if isdam else ".db"))
        if not os.path.exists(stubp):
            other = os.path.join(pwd, root + (".db" if isdam else ".dam"))
            if os.path.exists(other):
                stubp = other
            else:
                raise FileNotFoundError(
                    f"Cannot open database {root}[db|dam]")
        last = max(1, dbio.read_stub(stubp).nblocks)
    return [f"{base}.{k}" for k in range(first, last + 1)]


def main_damapper(argv: list[str]) -> int:
    """CLI with the reference's flag surface (damapper.c:53-56)."""
    kw = dict()
    args = []
    flags = set()
    masks = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) > 1 and not a[1].isdigit():
            c = a[1]
            if c in "vpzCN":
                # combined flag group: every character must be a legal flag
                # (ARG_FLAGS DB.h:88-99 errors on the first bad one)
                for ch in a[1:]:
                    if ch not in "vpzCN":
                        print(f"damapper: -{ch} is an illegal option",
                              file=sys.stderr)
                        return 1
                    flags.add(ch)
            elif c == "k":
                kw["kmer"] = int(a[2:])
            elif c == "t":
                kw["suppress"] = int(a[2:])
            elif c == "M":
                kw["mem_limit"] = int(a[2:]) << 30
            elif c == "e":
                kw["ave_error"] = float(a[2:])
            elif c == "s":
                kw["spacing"] = int(a[2:])
            elif c == "n":
                kw["best_tie"] = float(a[2:])
            elif c == "m":
                masks.append(a[2:])
            elif c in ("T", "P"):
                pass   # thread count / tmp dir: no-ops in this engine
            else:
                print(f"damapper: -{c} is an illegal option", file=sys.stderr)
                return 1
        else:
            args.append(a)
        i += 1

    if len(args) < 2:
        print("Usage: damapper [-vpzCN] [-k<int>] [-t<int>] [-M<int>] "
              "[-e<double>] [-s<int>] [-n<double>] [-m<track>]+ "
              "<reference:dam> <reads:db> ...", file=sys.stderr)
        return 1

    cover = "C" in flags
    nomap = "N" in flags
    if nomap and not cover:
        print("damapper: Cannot specify N flag without C also",
              file=sys.stderr)
        return 1
    if nomap and "p" in flags:
        print("damapper: Cannot specify both N and p flags together",
              file=sys.stderr)
        return 1

    cfg = DamapperConfig(masks=masks, verbose="v" in flags,
                         profile="p" in flags, do_a=not nomap, do_b=cover,
                         map_order="z" not in flags, **kw)
    if not (.7 <= cfg.ave_error < 1.):
        print("damapper: Average correlation must be in [.7,1.)",
              file=sys.stderr)
        return 1
    if cfg.kmer > 32:
        print("damapper: K-mer length must be 32 or less", file=sys.stderr)
        return 1
    if not (.7 <= cfg.best_tie <= 1.):
        print("damapper: Near optimal threshold must be in [.7,1.]",
              file=sys.stderr)
        return 1

    for arg in args[1:]:
        for reads in expand_db_block_arg(arg):
            run_damapper(args[0], reads, cfg)
    return 0

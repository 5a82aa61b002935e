"""Smoke test of the mapper on one GPU, through its normal entry points.

Phases, in order; any failure exits non-zero before the last line:

  a. device   JAX must run on a GPU.  Prints its kind and nvidia-smi's card
              name and power limit.
  b. full run A simulated 140 Mb reference in 500 kb contigs and --reads
              PacBio-class reads (3-9 kb, 15% error), mapped by
              `damapper -v ref.dam reads.db` with the default flags (device
              index and join, host chain sweep, wave kernel).  Prints wall
              seconds, reads/s, stage seconds, peak device bytes and the
              wave lane split; the .las must be non-empty and pass lacheck.
  c. kernel   >= 256 seeds captured from phase b (DAMAPPER_WAVE_DUMP) run
              through the wave kernel on the card and through the host
              oracle; every lane must match exactly.  Prints ms/lane of the
              kernel and of the XLA while-loop engine on the same lanes.
  d. pipeline The first 32 reads mapped by the default path and by the
              plain host path (oracle wave, host index) give equal records.
  e. tests    The tests marked `gpu`.

With --four only the four-card check runs: the phase-b job on a
(dp=2, ref=2) mesh over four GPUs and on one GPU must give identical
records.  The mesh job runs first in the process, so the peak bytes it
prints for each card are that job's alone.

The last line of output is one JSON object:
  {"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}

Data is generated from --seed into build/smoke/ inside the checkout.

Usage: python chip_smoke.py [--seed N] [--reads N] [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import pickle
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
GENOME_BP = 140_000_000
CONTIG_BP = 500_000
PARITY_LANES = 512       # seeds replayed in phase c
MIN_PARITY_LANES = 256


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


# --- data -------------------------------------------------------------------

def build_dataset(work: pathlib.Path, seed: int, nreads: int,
                  genome_bp: int) -> list[str]:
    """Simulated reference (`ref.dam`, one block) and reads (`reads.db`);
    returns the reads."""
    import numpy as np

    from damapper_tpu.io import db as dbio
    from damapper_tpu.io import fasta
    from tests import helpers

    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome = helpers.sim_genome(rng, genome_bp)
    ncontigs = max(2, genome_bp // CONTIG_BP)
    clen = genome_bp // ncontigs
    entries = [fasta.FastaEntry(f"ctg{i}", genome[i * clen:(i + 1) * clen])
               for i in range(ncontigs)]
    reads = []
    for _ in range(nreads):
        ci = int(rng.integers(0, ncontigs))
        r, *_ = helpers.sim_read(rng, entries[ci].seq, min_len=3000,
                                 max_len=9000)
        reads.append(r)
    dbio.create_dam(str(work / "ref.dam"), entries, bsize=260_000_000)
    dbio.create_db(str(work / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r) for i, r in enumerate(reads)])
    return reads


def peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", 0))


def read_las(path):
    from damapper_tpu.io import las as lasio
    return lasio.read_las(str(path))[0]


# --- phases -----------------------------------------------------------------

def phase_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        fail(f"JAX runs on {dev.platform!r}, not a GPU")
    log(f"[a] device: {dev.device_kind} x{len(jax.devices())}")
    log("[a] card (nvidia-smi name, power.limit):")
    log(card_line())
    return dev


def map_job(work: pathlib.Path, argv: list[str], dump=None) -> float:
    """Run `damapper` in `work` with cold reference caches (like a fresh
    invocation); returns wall seconds."""
    from damapper_tpu.cli import main as cli_main
    from damapper_tpu.pipeline import mapper, reporter

    mapper._ref_index_cache.clear()
    mapper._ref_index_cache_bytes[0] = 0
    reporter._ref_seq_cache.clear()
    if dump is not None:
        dump.unlink(missing_ok=True)
        os.environ["DAMAPPER_WAVE_DUMP"] = str(dump)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        rc = cli_main(["damapper"] + argv)
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        os.environ.pop("DAMAPPER_WAVE_DUMP", None)
    if rc != 0:
        fail(f"damapper exited {rc}")
    return wall


def phase_full_run(work: pathlib.Path, nreads: int, dev) -> None:
    from damapper_tpu.cli import main as cli_main
    from damapper_tpu.pipeline import mapper

    argv = ["-v", "ref.dam", "reads.db"]
    for run in ("cold, compiles included", "warm"):
        wall = map_job(work, argv, work / "seeds.pkl"
                       if run == "warm" else None)
        st = mapper.LAST_STATS
        log(f"[b] {run}: {GENOME_BP} bp reference, {nreads} reads: wall "
            f"{wall:.3f} s, {nreads / wall:.3f} reads/s")
        log(f"[b] {run}: stage seconds " + json.dumps(
            {k: round(v, 3) for k, v in st["times"].items()})
            + f"; align device {st['align_device_s']} s, host "
            f"{st['align_host_s']} s")
    las = work / "reads.ref.las"
    recs = read_las(las)
    if not recs:
        fail("the .las holds no records")
    if cli_main(["lacheck", str(las)]) != 0:
        fail("lacheck rejected the .las")
    ndev = st["n_lanes"] - st["n_fallback"] - st["n_hostmin"]
    log(f"[b] {len(recs)} records, lacheck ok; peak device bytes "
        f"{peak_bytes(dev)}")
    log(f"[b] wave lanes: {st['n_lanes']} total, {ndev} device, "
        f"{st['n_fallback']} overflow-fallback, {st['n_hostmin']} "
        f"tiny-round host")


def _oracle_lane(args):
    from damapper_tpu.ops import wave
    a, b, spec, s = args
    ap, bp = wave.local_alignment(a, b, spec, int(s["diag"]), int(s["diag"]),
                                  int(s["anti"]), -1, -1, int(s["flags"]))
    return _key(ap, bp)


def _key(ap, bp):
    return (ap.abpos, ap.bbpos, ap.aepos, ap.bepos, ap.diffs,
            tuple(int(x) for x in ap.trace), bp.abpos, bp.bbpos, bp.aepos,
            bp.bepos, tuple(int(x) for x in bp.trace))


def phase_kernel(work: pathlib.Path):
    import multiprocessing as mp

    import jax.numpy as jnp
    import numpy as np

    from damapper_tpu.io import db as dbio
    from damapper_tpu.ops.spec import new_align_spec
    from damapper_tpu.ops.wave_jax import WaveEngine
    from damapper_tpu.ops.wave_kernel import KernelWaveEngine
    from damapper_tpu.pipeline.reporter import align_memory_a

    seeds = []
    with open(work / "seeds.pkl", "rb") as fh:
        while len(seeds) < PARITY_LANES:
            try:
                seeds.extend(pickle.load(fh))
            except EOFError:
                break
    seeds = seeds[:PARITY_LANES]
    if len(seeds) < MIN_PARITY_LANES:
        fail(f"phase b produced {len(seeds)} wave seeds, need >= "
             f"{MIN_PARITY_LANES}")

    reads = dbio.DazzDB.open(str(work / "reads.db"))
    reads.trim()
    reads.load_bases()
    ref = dbio.DazzDB.open(str(work / "ref.dam"))
    ref.trim()
    ref.load_bases()
    Anp, _ = align_memory_a(reads)
    Bnp = ref.seq
    spec = new_align_spec(.85, 100, np.asarray(ref.freq), True)
    Adev, Bdev = jnp.asarray(Anp), jnp.asarray(Bnp)

    tasks = [(Anp[s["abase"]:s["abase"] + s["alen"]],
              Bnp[s["bbase"]:s["bbase"] + s["blen"]], spec, s) for s in seeds]
    with mp.get_context("spawn").Pool(min(16, os.cpu_count() or 1)) as pool:
        want = pool.map(_oracle_lane, tasks, chunksize=8)

    engines = (("wave kernel", KernelWaveEngine(spec)),
               ("while-loop engine", WaveEngine(spec, band_cap=128)))
    for name, eng in engines:
        eng.host_min = 0
        got = eng.local_alignment_batch(Adev, Bdev, Anp, Bnp, seeds)  # warm
        t0, run0 = time.perf_counter(), eng.t_run
        got = eng.local_alignment_batch(Adev, Bdev, Anp, Bnp, seeds)
        dt, run = time.perf_counter() - t0, eng.t_run - run0
        bad = sum(_key(*g) != w for g, w in zip(got, want))
        log(f"[c] {name}: {len(seeds)} lanes, {bad} mismatching; "
            f"{1e3 * dt / len(seeds):.4f} ms/lane end to end, "
            f"{1e3 * run / len(seeds):.4f} ms/lane in passes (device and "
            f"pull); {eng.n_fallback // 2} overflow-fallback")
        if bad:
            fail(f"{name}: {bad} of {len(seeds)} lanes differ from the "
                 f"host oracle")


def phase_pipeline(work: pathlib.Path, reads: list[str]):
    from damapper_tpu.io import db as dbio
    from damapper_tpu.io import fasta
    from damapper_tpu.io import las as lasio
    from damapper_tpu.pipeline.mapper import DamapperConfig, run_damapper

    dbio.create_db(str(work / "reads32.db"),
                   [fasta.FastaEntry(f"r{i}", r)
                    for i, r in enumerate(reads[:32])])
    outs = {}
    for name, cfg in (("default", DamapperConfig()),
                      ("plain", DamapperConfig(wave_backend="oracle",
                                               index_backend="host"))):
        out = work / f"d_{name}"
        out.mkdir(exist_ok=True)
        t0 = time.perf_counter()
        a, _ = run_damapper(str(work / "ref.dam"), str(work / "reads32.db"),
                            cfg, out_dir=str(out))
        outs[name] = read_las(a)
        log(f"[d] {name} path ({cfg.index_backend} index, "
            f"{cfg.wave_backend} wave): {len(outs[name])} records, "
            f"{time.perf_counter() - t0:.3f} s")
    same = lasio.las_equal(outs["default"], outs["plain"])
    log(f"[d] las_equal: {same}")
    if not outs["default"] or not same:
        fail("32-read job differs between the device and host paths")


def phase_tests():
    import pytest

    os.chdir(REPO)
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(REPO / "tests")])
    log(f"[e] gpu tests: pytest exit {int(rc)}")
    if rc != 0:
        fail("tests marked gpu failed")


def phase_four(work: pathlib.Path, nreads: int):
    import jax

    from damapper_tpu.parallel.mesh import make_mesh
    from damapper_tpu.pipeline.mapper import DamapperConfig, run_damapper
    from damapper_tpu.io import las as lasio

    devs = jax.devices()
    if len(devs) < 4:
        fail(f"--four needs 4 GPUs, found {len(devs)}")
    log(f"[four] peak device bytes per card before any job: "
        f"{[peak_bytes(d) for d in devs[:4]]}")
    outs = {}
    # the mesh job first: the per-card peaks read after it are its own
    for name, mesh in (("(dp=2, ref=2) mesh", make_mesh(4, ref_shards=2)),
                       ("one card", None)):
        out = work / ("four" if mesh is not None else "one")
        out.mkdir(exist_ok=True)
        t0 = time.perf_counter()
        a, _ = run_damapper(str(work / "ref.dam"), str(work / "reads.db"),
                            DamapperConfig(mesh=mesh), out_dir=str(out))
        outs[name] = read_las(a)
        log(f"[four] {name}: {len(outs[name])} records, "
            f"{time.perf_counter() - t0:.3f} s for {nreads} reads")
        if mesh is not None:
            peaks = [peak_bytes(d) for d in devs[:4]]
            log(f"[four] mesh job's peak device bytes per card: {peaks}")
    same = lasio.las_equal(outs["one card"], outs["(dp=2, ref=2) mesh"])
    log(f"[four] records identical: {same}")
    if not same or not outs["one card"]:
        fail("the four-card mesh run differs from the one-card run")
    if min(peaks) <= 0:
        fail("a card of the mesh did no work")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reads", type=int, default=1000)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh check")
    args = ap.parse_args()

    if not (REPO / "damapper_tpu" / "__init__.py").is_file():
        fail(f"no damapper_tpu package next to {pathlib.Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    os.environ.setdefault("JAX_PLATFORMS", "cuda")

    from damapper_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    dev = phase_device()
    work = REPO / "build" / "smoke" / f"seed{args.seed}_r{args.reads}"
    t0 = time.perf_counter()
    reads = build_dataset(work, args.seed, args.reads, GENOME_BP)
    log(f"[b] data: {GENOME_BP} bp in {CONTIG_BP} bp contigs, {args.reads} "
        f"reads of 3-9 kb at 15% error, built in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    if args.four:
        phase_four(work, args.reads)
    else:
        phase_full_run(work, args.reads, dev)
        phase_kernel(work)
        phase_pipeline(work, reads)
        phase_tests()

    import jax
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": 4 if args.four else len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

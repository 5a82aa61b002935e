"""Multi-chip execution: device meshes + the multichip validation run.

The reference scales three ways (SURVEY.md §2.2): pthreads inside a process,
reference-block streaming against a resident reads index, and cluster-level
data parallelism over read blocks via generated shell scripts
(HPC.damapper.c).  The device equivalents, wired into the REAL pipeline
(pipeline.mapper.run_damapper):

  * axis "dp"  — read/seed data parallelism (the reference's thread + cluster
                 parallelism, map.c:2966-2978 / HPC.damapper.c:359-443):
                 each device owns a shard of the reads k-mer index and of the
                 batched wave lanes.
  * axis "ref" — reference k-mer index sharding (the memory axis of the
                 reference's block streaming, damapper.c:835-864): each
                 device owns a contiguous slice of the sorted reference
                 index; per-group hit totals merge with a psum across devices
                 (ops.device_index.device_match_seeds_sharded) instead of the
                 coff-cache accumulation (map.c:2874-2888).

`dryrun(n)` is the driver's multichip validation: it runs the ACTUAL mapper
twice on a small simulated dataset — single-device versus an n-device
(dp, ref) mesh with the sharded index/match/wave path — and asserts the
final `.las` records are identical.
"""

from __future__ import annotations

import os
import tempfile

import jax
import numpy as np
from jax.sharding import Mesh

_BASES = "ACGT"


def make_mesh(n_devices: int | None = None, ref_shards: int | None = None,
              devices=None) -> Mesh:
    """Build a (dp, ref) mesh over `devices` (default: all devices).

    When the device list spans processes (cooperative multi-host mode) the
    layout puts "ref" ACROSS the process boundary: the reference k-mer
    index is the memory axis (BASELINE config 5's "index sharded over
    N>=2 hosts"), so each host holds 1/ref_shards of it and the matcher's
    psum rides DCN; "dp" stays within a host."""
    devs = jax.devices() if devices is None else list(devices)
    n = len(devs) if n_devices is None else n_devices
    devs = devs[:n]
    if ref_shards is None:
        ref_shards = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // ref_shards
    pid0 = devs[0].process_index
    if any(d.process_index != pid0 for d in devs):
        if ref_shards == 1:
            # every multi-host mesh shards the index: that is its point
            ref_shards, dp = dp, 1
        arr = np.array(devs).reshape(ref_shards, dp).T
    else:
        arr = np.array(devs).reshape(dp, ref_shards)
    return Mesh(arr, ("dp", "ref"))


def _sim_genome(rng, length: int) -> str:
    return "".join(_BASES[i] for i in rng.integers(0, 4, size=length))


def _sim_read(rng, genome: str, min_len=1500, max_len=4000, err=0.15) -> str:
    L = len(genome)
    n = min(int(rng.integers(min_len, max_len + 1)), L - 1)
    start = int(rng.integers(0, L - n))
    frag = genome[start:start + n]
    if rng.integers(0, 2):
        frag = frag.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    out = []
    for ch in frag:
        r = rng.random()
        if r < err:
            e = rng.random()
            if e < 0.55:
                out.append(_BASES[rng.integers(0, 4)])
                out.append(ch)
            elif e < 0.80:
                pass
            else:
                out.append(_BASES[(_BASES.index(ch) + 1
                                   + rng.integers(0, 3)) % 4])
        else:
            out.append(ch)
    return "".join(out)


def dryrun(n_devices: int) -> None:
    """Execute the REAL mapper single-device and on an n-device (dp, ref)
    mesh (sharded index + sharded seed match + dp-sharded waves) and require
    record-identical `.las` output (the driver's multichip validation;
    see __graft_entry__.dryrun_multichip)."""
    from ..io import db as dbio
    from ..io import fasta
    from ..io import las as lasio
    from ..pipeline.mapper import DamapperConfig, run_damapper

    rng = np.random.default_rng(12)
    # >=1 Mb genome with a skewed repeat family (a 500 bp unit tiled 60x):
    # large enough to exercise the matcher's ncap bucketing and per-shard
    # emission caps under non-uniform k-mer multiplicities, small enough
    # to keep the 8-virtual-device CPU run bounded
    glen = 1_000_000
    unit = _sim_genome(rng, 500)
    core = _sim_genome(rng, glen - 60 * 500)
    genome = core[:glen // 3] + unit * 60 + core[glen // 3:]
    entries = [fasta.FastaEntry("ctg0", genome[:glen // 2]),
               fasta.FastaEntry("ctg1", genome[glen // 2:])]
    reads = [_sim_read(rng, genome) for _ in range(100)]

    mesh = make_mesh(n_devices, ref_shards=2 if n_devices % 2 == 0 else 1)

    with tempfile.TemporaryDirectory() as tmp:
        dbio.create_dam(os.path.join(tmp, "ref.dam"), entries, bsize=25_000)
        dbio.create_db(os.path.join(tmp, "reads.db"),
                       [fasta.FastaEntry(f"r{i}", r)
                        for i, r in enumerate(reads)])
        outs = {}
        for name, m in (("single", None), ("mesh", mesh)):
            out = os.path.join(tmp, name)
            os.mkdir(out)
            cfg = DamapperConfig(wave_backend="jax", index_backend="device",
                                 mesh=m)
            a, _ = run_damapper(os.path.join(tmp, "ref.dam"),
                                os.path.join(tmp, "reads.db"), cfg,
                                out_dir=out)
            outs[name], _ = lasio.read_las(a)
        assert len(outs["single"]) > 0, "dryrun produced no alignments"
        assert lasio.las_equal(outs["single"], outs["mesh"]), \
            "multichip .las differs from single-device"

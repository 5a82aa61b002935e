"""Differential tests: batched device wave engine vs the host oracle
(which is itself differentially verified against the reference binary)."""

import jax.numpy as jnp
import numpy as np
import pytest

from damapper_tpu.io import db as dbio
from damapper_tpu.ops import wave
from damapper_tpu.ops.spec import new_align_spec
from damapper_tpu.ops.wave_jax import WaveEngine
from tests import helpers


def make_cases(seed, ncases, glen=6000, rlen=2500, err=0.15,
               mix=False):
    """Build a flat sentinel-separated sequence memory plus seed instances,
    mimicking the loaded-DB layout.  mix=True draws each read's length
    uniformly from [min(1500, rlen), rlen] — the bench-like length
    heterogeneity that exposes band-overflow fallback costs a fixed-length
    harness hides."""
    rng = np.random.default_rng(seed)
    genome = helpers.sim_genome(rng, glen)
    g = dbio.seq_to_numeric(genome)

    flat = [np.array([4], np.uint8)]
    off = 1
    entries = []
    for _ in range(ncases):
        rl = (int(rng.integers(min(1500, rlen), rlen + 1)) if mix
              else rlen)
        start = int(rng.integers(0, glen - rl))
        frag = genome[start:start + rl]
        out = []
        truth = []
        bpos = 0
        for i, ch in enumerate(frag):
            if rng.random() < err:
                t = rng.random()
                if t < 0.55:
                    out.append("ACGT"[rng.integers(0, 4)])
                    out.append(ch)
                    truth.append((start + i, bpos + 1))
                    bpos += 2
                elif t < 0.80:
                    pass
                else:
                    out.append("ACGT"[(("ACGT".index(ch)) + 1) % 4])
                    bpos += 1
            else:
                out.append(ch)
                truth.append((start + i, bpos))
                bpos += 1
        b = dbio.seq_to_numeric("".join(out))
        apos, bp = truth[len(truth) // 2]
        entries.append((b, apos + 1, bp + 1))

    # layout: genome first, then each read, sentinel-separated
    gbase = off
    flat.append(g)
    off += len(g)
    insts = []
    for b, apos, bp in entries:
        flat.append(np.array([4], np.uint8))
        off += 1
        bbase = off
        flat.append(b)
        off += len(b)
        insts.append(dict(abase=gbase, alen=len(g), bbase=bbase, blen=len(b),
                          diag=apos - bp, anti=apos + bp, flags=0))
    flat.append(np.array([4], np.uint8))
    seqmem = np.concatenate(flat)
    return seqmem, insts


@pytest.mark.parametrize("seed,err", [(0, 0.15), (1, 0.15), (2, 0.05),
                                      (3, 0.30), (4, 0.15)])
def test_wave_jax_matches_oracle(seed, err):
    seqmem, insts = make_cases(1000 + seed, ncases=6, err=err)
    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    eng = WaveEngine(spec, band_cap=256, pool_cap=2048)
    dev = jnp.asarray(seqmem)
    got = eng.local_alignment_batch(dev, dev, seqmem, seqmem, insts)
    for i, s in enumerate(insts):
        a_np = seqmem[s["abase"]:s["abase"] + s["alen"]]
        b_np = seqmem[s["bbase"]:s["bbase"] + s["blen"]]
        ea, eb = wave.local_alignment(a_np, b_np, spec, s["diag"], s["diag"],
                                      s["anti"], -1, -1, s["flags"])
        ga, gb = got[i]
        for nm, e, g in (("A", ea, ga), ("B", eb, gb)):
            assert (e.abpos, e.bbpos, e.aepos, e.bepos, e.diffs) == \
                   (g.abpos, g.bbpos, g.aepos, g.bepos, g.diffs), \
                   f"case {i} {nm}: {(e.abpos,e.bbpos,e.aepos,e.bepos,e.diffs)}" \
                   f" vs {(g.abpos,g.bbpos,g.aepos,g.bepos,g.diffs)}"
            assert list(e.trace) == list(g.trace), f"case {i} {nm} trace"


def test_wave_jax_boundary_reach():
    """Seeds near contig boundaries exercise sentinel clipping + REACH."""
    seqmem, insts = make_cases(2000, ncases=4, glen=2600, rlen=2500)
    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    eng = WaveEngine(spec, band_cap=256, pool_cap=2048)
    dev = jnp.asarray(seqmem)
    got = eng.local_alignment_batch(dev, dev, seqmem, seqmem, insts)
    for i, s in enumerate(insts):
        a_np = seqmem[s["abase"]:s["abase"] + s["alen"]]
        b_np = seqmem[s["bbase"]:s["bbase"] + s["blen"]]
        ea, eb = wave.local_alignment(a_np, b_np, spec, s["diag"], s["diag"],
                                      s["anti"], -1, -1, s["flags"])
        ga, gb = got[i]
        assert (ea.abpos, ea.bbpos, ea.aepos, ea.bepos, ea.diffs) == \
               (ga.abpos, ga.bbpos, ga.aepos, ga.bepos, ga.diffs)
        assert list(ea.trace) == list(ga.trace)
        assert list(eb.trace) == list(gb.trace)


def assert_matches_oracle(eng, seqmem, insts, spec):
    """Run `insts` through `eng` and require every lane to equal the host
    oracle: coordinates, diffs and both trace-point lists."""
    dev = jnp.asarray(seqmem)
    got = eng.local_alignment_batch(dev, dev, seqmem, seqmem, insts)
    for i, s in enumerate(insts):
        a_np = seqmem[s["abase"]:s["abase"] + s["alen"]]
        b_np = seqmem[s["bbase"]:s["bbase"] + s["blen"]]
        ea, eb = wave.local_alignment(a_np, b_np, spec, s["diag"], s["diag"],
                                      s["anti"], -1, -1, s["flags"])
        ga, gb = got[i]
        assert (ea.abpos, ea.bbpos, ea.aepos, ea.bepos, ea.diffs) == \
               (ga.abpos, ga.bbpos, ga.aepos, ga.bepos, ga.diffs), f"case {i}"
        assert list(ea.trace) == list(ga.trace), f"case {i} A trace"
        assert list(eb.trace) == list(gb.trace), f"case {i} B trace"
    return got


@pytest.mark.parametrize("seed,err", [(0, 0.15), (3, 0.30), (1, 0.05),
                                      (2, 0.15), (4, 0.30)])
def test_wave_pallas_matches_oracle(seed, err):
    """The device engine (the wave kernel; here its host build) at band 64
    must reproduce the oracle exactly, like the while-loop engine."""
    from damapper_tpu.ops.wave_kernel import KernelWaveEngine

    seqmem, insts = make_cases(1000 + seed, ncases=4, err=err)
    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    eng = KernelWaveEngine(spec, band_cap=64, pool_cap=2048, platform="cpu")
    assert_matches_oracle(eng, seqmem, insts, spec)


def test_tiny_round_host_route_identical():
    """Rounds below engine.host_min run on the host oracle; the routed
    results must equal the device path exactly (they share the oracle's
    parity contract, so this pins the routing itself)."""
    seqmem, insts = make_cases(3000, ncases=4, err=0.15)
    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    dev = jnp.asarray(seqmem)
    eng_dev = WaveEngine(spec, band_cap=256, pool_cap=2048)
    eng_dev.host_min = 0
    eng_host = WaveEngine(spec, band_cap=256, pool_cap=2048)
    eng_host.host_min = len(insts) + 1
    got_d = eng_dev.local_alignment_batch(dev, dev, seqmem, seqmem, insts)
    got_h = eng_host.local_alignment_batch(dev, dev, seqmem, seqmem, insts)
    for i, ((da, db_), (ha, hb)) in enumerate(zip(got_d, got_h)):
        for nm, d, h in (("A", da, ha), ("B", db_, hb)):
            assert (d.abpos, d.bbpos, d.aepos, d.bepos, d.diffs) == \
                   (h.abpos, h.bbpos, h.aepos, h.bepos, h.diffs), f"{i} {nm}"
            assert list(d.trace) == list(h.trace), f"{i} {nm} trace"


def _clip_cases(seed, ncases):
    import pathlib
    import sys
    sys.path.insert(0, str(helpers.REPO / "tools"))
    import clip_fuzz
    return clip_fuzz.make_clip_cases(seed, ncases)


@pytest.mark.parametrize("engine", ["jax", "kernel_cpu"])
def test_wave_boundary_clip_coast(engine):
    """Reverse waves that dive off the START of A and coast: a junk read
    head makes A-gap paths touch x == 0 (clip + REACH grab) while better
    off-boundary frontiers keep the wave alive, so the band re-clips over
    many waves.  Regression for two round-4 parity bugs (the 50k-read
    edge): (a) the post-clip band prune re-based pre-clip slot positions
    onto the post-clip low, losing the diagonals just above aclip; (b) a
    lockstep segment driver's loop cond skipped the deferred REACH rest resolution
    when the last live lane stalled on a clip, ending its wave early."""
    seqmem, all_insts = _clip_cases(7000, 117)
    # cases known to trip the two old bugs (band_cap=128) + controls
    insts = [all_insts[i] for i in (0, 14, 46, 50, 55, 67, 116)]
    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    if engine == "jax":
        eng = WaveEngine(spec, band_cap=128, pool_cap=2048)
    else:
        from damapper_tpu.ops.wave_kernel import KernelWaveEngine
        eng = KernelWaveEngine(spec, band_cap=128, pool_cap=2048,
                               platform="cpu")
    eng.host_min = 0
    dev = jnp.asarray(seqmem)
    got = eng.local_alignment_batch(dev, dev, seqmem, seqmem, insts)
    nbad = 0
    for i, s in enumerate(insts):
        a_np = seqmem[s["abase"]:s["abase"] + s["alen"]]
        b_np = seqmem[s["bbase"]:s["bbase"] + s["blen"]]
        ea, eb = wave.local_alignment(a_np, b_np, spec, s["diag"],
                                      s["diag"], s["anti"], -1, -1,
                                      s["flags"])
        ga, gb = got[i]
        same = ((ea.abpos, ea.bbpos, ea.aepos, ea.bepos, ea.diffs)
                == (ga.abpos, ga.bbpos, ga.aepos, ga.bepos, ga.diffs)
                and list(ea.trace) == list(ga.trace)
                and list(eb.trace) == list(gb.trace))
        nbad += not same
    assert nbad == 0, f"{nbad}/{len(insts)} clip-coast lanes diverge"

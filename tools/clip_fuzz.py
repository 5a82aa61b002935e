"""Boundary-clip-targeted differential fuzz: device engine vs host oracle.

Generates lanes whose reverse wave walks off the START of the A sequence
(abpos == 0) so the band clips at the A boundary and re-clips under REACH
— the lane class where the 50k-read parity edge lives (STATUS.md).

Usage: JAX_PLATFORMS=cpu python tools/clip_fuzz.py [nseeds] [--kernel]

Without --kernel the engine is the XLA while-loop engine (ops/wave_jax.py);
with it, the wave kernel (its host build on the CPU).
"""

import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from damapper_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from damapper_tpu.io import db as dbio  # noqa: E402
from damapper_tpu.ops import wave  # noqa: E402
from damapper_tpu.ops.spec import new_align_spec  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tests"))
from tests import helpers  # noqa: E402


def make_clip_cases(seed, ncases, glen=12000, rlen=360,
                    err_head=0.22, err_tail=0.12, head=110, junk=48):
    """Reads whose reverse wave dives off the START of A and keeps going.

    Each read is [junk random bases | noisy genome fragment] with the seed
    near the read end.  The reverse wave walks cleanly back to the junk
    head; inside the junk, A-gap-leaning paths touch x == 0 (clip + REACH
    grab) while luckier off-boundary frontiers keep the wave alive
    (rest == True), so the band re-clips at successive diagonals over many
    waves — the exact lane class of the 50k parity edge (STATUS.md): the
    post-clip band prune must keep the diagonals just above aclip or a
    later, better-M boundary grab is lost."""
    rng = np.random.default_rng(seed)
    genome = helpers.sim_genome(rng, glen)

    flat = [np.array([4], np.uint8)]
    off = 1
    gbase = off
    flat.append(dbio.seq_to_numeric(genome))
    off += glen
    insts = []
    for _ in range(ncases):
        start = int(rng.integers(0, glen - rlen - 100))
        frag = genome[start:start + rlen]
        out = []
        truth = []   # (bpos_in_genome_abs, apos_in_read)
        apos = 0
        for i, ch in enumerate(frag):
            err = err_head if i < head else err_tail
            if rng.random() < err:
                t = rng.random()
                if t < 0.55:           # insertion in the read
                    out.append("ACGT"[rng.integers(0, 4)])
                    out.append(ch)
                    truth.append((start + i, apos + 1))
                    apos += 2
                elif t < 0.80:         # deletion
                    pass
                else:                  # substitution
                    out.append("ACGT"[(("ACGT".index(ch)) + 1) % 4])
                    apos += 1
            else:
                out.append(ch)
                truth.append((start + i, apos))
                apos += 1
        jhead = "".join("ACGT"[j] for j in rng.integers(0, 4, junk))
        read = dbio.seq_to_numeric(jhead + "".join(out))
        # seed ~7/8 into the read so the reverse wave has a long run back
        # to the A start (the read is A, the genome is B)
        gpos, rpos = truth[(7 * len(truth)) // 8]
        rpos += junk
        flat.append(np.array([4], np.uint8))
        off += 1
        abase = off
        flat.append(read)
        off += len(read)
        insts.append(dict(abase=abase, alen=len(read), bbase=gbase,
                          blen=glen, diag=rpos - gpos,
                          anti=(rpos + 1) + (gpos + 1), flags=0))
    flat.append(np.array([4], np.uint8))
    return np.concatenate(flat), insts


def run(seed, ncases, engine_cls, W):
    seqmem, insts = make_clip_cases(seed, ncases)
    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    eng = engine_cls(spec, band_cap=W, pool_cap=2048)
    eng.host_min = 0
    dev = jnp.asarray(seqmem)
    got = eng.local_alignment_batch(dev, dev, seqmem, seqmem, insts)
    bad = 0
    for i, s in enumerate(insts):
        a_np = seqmem[s["abase"]:s["abase"] + s["alen"]]
        b_np = seqmem[s["bbase"]:s["bbase"] + s["blen"]]
        ea, eb = wave.local_alignment(a_np, b_np, spec, s["diag"], s["diag"],
                                      s["anti"], -1, -1, s["flags"])
        ga, gb = got[i]
        ek = (ea.abpos, ea.bbpos, ea.aepos, ea.bepos, ea.diffs,
              tuple(ea.trace), tuple(eb.trace))
        gk = (ga.abpos, ga.bbpos, ga.aepos, ga.bepos, ga.diffs,
              tuple(ga.trace), tuple(gb.trace))
        if ek != gk:
            bad += 1
            print(f"seed={seed} case={i}: oracle "
                  f"{(ea.abpos, ea.bbpos, ea.aepos, ea.bepos, ea.diffs)} "
                  f"engine {(ga.abpos, ga.bbpos, ga.aepos, ga.bepos, ga.diffs)}"
                  f" tracediff={list(ea.trace) != list(ga.trace)}")
    return bad, eng.n_fallback


def run_oracle_vs_reference(seed, ncases):
    """Differential fuzz of the HOST ORACLE against the reference binary's
    Local_Alignment (tests/la_driver.c) on the same clip-heavy seeds."""
    from tests.test_wave import run_reference_la

    seqmem, insts = make_clip_cases(seed, ncases)
    spec_args = (0.85, 100, 1, [.25, .25, .25, .25])
    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    bad = 0
    for i, s in enumerate(insts):
        a_np = seqmem[s["abase"]:s["abase"] + s["alen"]]
        b_np = seqmem[s["bbase"]:s["bbase"] + s["blen"]]
        ea, eb = wave.local_alignment(a_np, b_np, spec, s["diag"], s["diag"],
                                      s["anti"], -1, -1, s["flags"])
        ra, rb = run_reference_la(spec_args, s["flags"], s["diag"],
                                  s["diag"], s["anti"], a_np, b_np)
        ok = ((ea.abpos, ea.bbpos, ea.aepos, ea.bepos, ea.diffs)
              == (ra["abpos"], ra["bbpos"], ra["aepos"], ra["bepos"],
                  ra["diffs"])
              and list(ea.trace) == ra["trace"]
              and list(eb.trace) == rb["trace"])
        if not ok:
            bad += 1
            print(f"seed={seed} case={i}: oracle "
                  f"{(ea.abpos, ea.bbpos, ea.aepos, ea.bepos, ea.diffs)} "
                  f"reference {(ra['abpos'], ra['bbpos'], ra['aepos'], ra['bepos'], ra['diffs'])}")
    return bad


def main():
    nseeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    ncases_o = int(os.environ.get("FUZZ_CASES", 256))
    if "--oracle" in sys.argv:
        total = 0
        for seed in range(nseeds):
            bad = run_oracle_vs_reference(7000 + seed, ncases_o)
            total += bad
            print(f"seed {7000 + seed}: {bad} oracle-vs-reference mismatches")
        print(f"TOTAL: {total} mismatches")
        sys.exit(1 if total else 0)
    if "--kernel" in sys.argv:
        from damapper_tpu.ops.wave_kernel import KernelWaveEngine as E
    else:
        from damapper_tpu.ops.wave_jax import WaveEngine as E
    W = int(os.environ.get("FUZZ_W", 128))
    ncases = int(os.environ.get("FUZZ_CASES", 256))
    total_bad = total_fb = 0
    for seed in range(nseeds):
        bad, fb = run(7000 + seed, ncases, E, W)
        total_bad += bad
        total_fb += fb
        print(f"seed {7000 + seed}: {bad} mismatches ({fb} fallbacks)")
    print(f"TOTAL: {total_bad} mismatches, {total_fb} fallbacks")
    sys.exit(1 if total_bad else 0)


if __name__ == "__main__":
    main()

"""End-to-end A/B of the wave engines on chip_smoke's job.

Maps the simulated 140 Mb / --reads job (chip_smoke.build_dataset) with
the wave kernel (DAMAPPER_WAVE=device) and with the XLA while-loop engine
(DAMAPPER_WAVE=jax), in turns (kernel, jax, jax, kernel) after one warm-up
run of each, every run with cold reference caches.  Then times tiny rounds
of real seeds on both engines against the host oracle: the measurement
behind each engine's HOST_MIN.  Needs a GPU.

Usage: python tools/wave_engine_ab.py [--reads N] [--seed N]
"""

import argparse
import os
import pathlib
import pickle
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from damapper_tpu.io import db as dbio
    from damapper_tpu.ops import wave
    from damapper_tpu.ops.spec import new_align_spec
    from damapper_tpu.ops.wave_jax import WaveEngine
    from damapper_tpu.ops.wave_kernel import KernelWaveEngine
    from damapper_tpu.pipeline import mapper
    from damapper_tpu.pipeline.reporter import align_memory_a
    from damapper_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, JAX runs on {dev.platform!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    work = REPO / "build" / "smoke" / f"ab_seed{args.seed}_r{args.reads}"
    chip_smoke.build_dataset(work, args.seed, args.reads,
                             chip_smoke.GENOME_BP)

    backends = {"kernel": "device", "jax": "jax"}
    argv = ["ref.dam", "reads.db"]
    for name in ("kernel", "jax", "jax", "kernel", "jax", "kernel"):
        os.environ["DAMAPPER_WAVE"] = backends[name]
        wall = chip_smoke.map_job(work, argv)
        st = mapper.LAST_STATS
        t = st["times"]
        print(f"{name}: wall {wall:.3f} s, align {t['align']:.3f} s "
              f"(device {st['align_device_s']} s, host "
              f"{st['align_host_s']} s), index {t['index']:.3f} s, match "
              f"{t['match']:.3f} s, lanes {st['n_lanes']} "
              f"(fallback {st['n_fallback']}, host {st['n_hostmin']})",
              flush=True)

    # tiny rounds: both engines vs the host oracle on the same real seeds
    dump = work / "seeds.pkl"
    os.environ["DAMAPPER_WAVE"] = "device"
    chip_smoke.map_job(work, argv, dump)
    os.environ.pop("DAMAPPER_WAVE")
    with open(dump, "rb") as fh:
        seeds = pickle.load(fh)
    reads = dbio.DazzDB.open(str(work / "reads.db"))
    reads.trim()
    reads.load_bases()
    ref = dbio.DazzDB.open(str(work / "ref.dam"))
    ref.trim()
    ref.load_bases()
    Anp, _ = align_memory_a(reads)
    Bnp = ref.seq
    Adev, Bdev = jnp.asarray(Anp), jnp.asarray(Bnp)
    spec = new_align_spec(.85, 100, np.asarray(ref.freq), True)
    engines = {"kernel": KernelWaveEngine(spec),
               "jax": WaveEngine(spec, band_cap=128)}
    for eng in engines.values():
        eng.host_min = 0
    for n in (1, 2, 4, 8, 16, 32):
        for off in range(0, 4 * n, n):
            batch = seeds[off:off + n]
            if len(batch) < n:
                break
            ms = {}
            for name, eng in engines.items():
                eng.local_alignment_batch(Adev, Bdev, Anp, Bnp, batch)
                t0 = time.perf_counter()
                eng.local_alignment_batch(Adev, Bdev, Anp, Bnp, batch)
                ms[name] = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            for s in batch:
                wave.local_alignment(
                    Anp[s["abase"]:s["abase"] + s["alen"]],
                    Bnp[s["bbase"]:s["bbase"] + s["blen"]], spec,
                    int(s["diag"]), int(s["diag"]), int(s["anti"]), -1, -1,
                    int(s["flags"]))
            to = time.perf_counter() - t0
            print(f"round of {n} lanes (seeds {off}..{off + n - 1}): kernel "
                  f"{ms['kernel']:.3f} ms, jax {ms['jax']:.3f} ms, host "
                  f"oracle {1e3 * to:.3f} ms", flush=True)


if __name__ == "__main__":
    main()

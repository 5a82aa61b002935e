"""Multi-host plan execution: the cluster runtime replacing HPC script
submission (reference HPC.damapper.c:359-498, README.md:79-89).

The reference's cluster model is embarrassingly-parallel `damapper` jobs
over read-block ranges, coordinated only by script barriers and the
filesystem.  Here each job is owned by a host rank of a `jax.distributed`
process group: workers initialize the distributed runtime (the DCN control
plane), run their owned read blocks through the real pipeline, meet at a
cross-host device barrier, and rank 0 performs the house-keeping block —
LAcheck over every output plus the cross-host `.las` concatenation (the
LAcat step of damapper.c:893-910).

`run_plan_multihost` is the single-machine launcher used by tests: it
spawns one CPU worker process per rank on localhost.  On a cluster each
host runs `python -m damapper_tpu.parallel.launch --rank R ...` with
the coordinator address of host 0.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shlex
import subprocess
import sys
import time


def _job_argv(cmd: str) -> list[str]:
    """Strip the launcher prefix off a plan job command, returning damapper
    CLI argv (the plan emits '... cli damapper <opts> <ref> <reads>...')."""
    toks = shlex.split(cmd)
    if "damapper" in toks:
        return toks[toks.index("damapper") + 1:]
    return toks


def worker_main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--coord", required=True)
    ap.add_argument("--plan", required=True, help="plan JSON file")
    ap.add_argument("--out", default=".")
    ap.add_argument("--global-index", action="store_true",
                    help="cooperative mode: every rank runs every job on "
                         "ONE global (dp, ref) device mesh whose ref axis "
                         "spans the hosts — the reference k-mer index is "
                         "sharded across hosts and seed matching merges "
                         "hit counts over DCN (BASELINE config 5). Pair "
                         "with DAMAPPER_INDEX=device.")
    args = ap.parse_args(argv)

    import jax

    jax.distributed.initialize(coordinator_address=args.coord,
                               num_processes=args.nprocs,
                               process_id=args.rank)
    from jax.experimental import multihost_utils

    with open(args.plan) as fp:
        plan = json.load(fp)

    from ..pipeline.mapper import main_damapper

    os.chdir(args.out)
    if args.global_index:
        # cooperative mode: the mapper's auto-mesh may span the ranks
        os.environ["DAMAPPER_COOP"] = "1"
    rc = 0
    for job in plan["jobs"]:
        if args.global_index:
            # cooperative job: all ranks execute the same program over one
            # cross-host mesh (host stages replicated, index sharded); the
            # rank-0 copy of the output is the canonical one
            print(f"[rank {args.rank}] blocks {job['blocks']} (global mesh)",
                  flush=True)
            rc |= main_damapper(_job_argv(job["cmd"]))
            continue
        if job["host"] % args.nprocs != args.rank:
            continue
        print(f"[rank {args.rank}] blocks {job['blocks']}", flush=True)
        rc |= main_damapper(_job_argv(job["cmd"]))

    # cross-host barrier (every host's blocks complete before house-keeping)
    print(f"[rank {args.rank}] blocks done rc={rc}", flush=True)
    multihost_utils.sync_global_devices("damapper_blocks_done")

    if args.rank == 0 and rc == 0:
        # house-keeping: LAcheck every block output, then the cross-host
        # merge into one .las; errors must still reach the final barrier
        # or the other ranks deadlock
        try:
            from ..cli import main as cli_main

            for cmd in plan.get("check", ()):
                toks = shlex.split(cmd)
                rc |= cli_main(toks[toks.index("lacheck"):])
            merge = plan.get("merge")
            if merge:
                toks = shlex.split(merge)
                rc |= cli_main(toks[toks.index("lamerge"):])
        except Exception as e:
            print(f"[rank 0] house-keeping failed: {e}", flush=True)
            rc = 1
    multihost_utils.sync_global_devices("damapper_done")
    print(f"[rank {args.rank}] exit rc={rc}", flush=True)
    jax.distributed.shutdown()
    return rc


def run_plan_multihost(plan_json: str, nprocs: int, workdir: str,
                       port: int | None = None,
                       env_extra: dict | None = None,
                       global_index: bool = False) -> dict:
    """Launch a plan across nprocs localhost worker processes.  Returns
    {"seconds": wall, "rc": int}.

    The workers run on the CPU (JAX_PLATFORMS=cpu, two virtual devices
    each): several processes on one host would otherwise contend for the
    same accelerator, and a JAX process reserves most of a card's memory.
    On a GPU host, one process drives every local card through the mesh.

    global_index=True runs every job cooperatively on one cross-process
    (dp, ref) mesh (reference index sharded across the ranks) instead of
    distributing jobs over ranks; pair with DAMAPPER_INDEX=device."""
    import socket

    if port is None:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    wd = pathlib.Path(workdir)
    planp = wd / "plan.json"
    planp.write_text(plan_json)

    env = dict(os.environ)
    repo = str(pathlib.Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_NUM_CPU_DEVICES", None)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=2").strip()
    if env_extra:
        env.update(env_extra)

    t0 = time.time()
    procs = []
    for r in range(nprocs):
        argv = [sys.executable, "-m", "damapper_tpu.parallel.launch",
                "--rank", str(r), "--nprocs", str(nprocs),
                "--coord", f"127.0.0.1:{port}", "--plan", str(planp),
                "--out", str(wd)]
        if global_index:
            argv.append("--global-index")
        procs.append(subprocess.Popen(
            argv, env=env, cwd=str(wd),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    rc = 0
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        logs.append(out.decode(errors="replace"))
        rc |= p.returncode
    return {"seconds": time.time() - t0, "rc": rc, "logs": logs}


if __name__ == "__main__":
    sys.exit(worker_main())

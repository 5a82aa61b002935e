"""The wave pass as one kernel launch per batch (the device wave engine).

`native/wave_lane.h` holds one lane of the forward or reverse pass, ported
line for line from the host oracle (ops/wave.py).  `native/wave_ffi.cu`
runs it one lane per thread on the GPU: each lane goes from its seed to its
trimmed tip in a single launch, with its band ring in local memory and its
sequence bytes read straight from device memory.  `native/wave_ffi.cc` runs
the same code on the host as an XLA CPU target: the engine on the CPU, so
the tests reach the kernel's arithmetic and this wrapper without a card.

Both libraries are built on first use into `native/build/` (CUDA with
`nvcc` for sm_90a).  The engine keeps WaveEngine's host side: bucketing,
trace extraction, the fshort/rshort refinement and the oracle fallback.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from .wave_jax import WaveEngine, shard_lanes

_NATIVE = pathlib.Path(__file__).resolve().parent.parent / "native"
_BUILD = _NATIVE / "build"
_SOURCES = {"cpu": "wave_ffi.cc", "cuda": "wave_ffi.cu"}
TARGET = "damapper_wave"
BANDS = (64, 128, 256)

# per-lane outputs, in the order of wave_lane.h's O_* enum
OUT_FIELDS = ("trima", "trimy", "trimd", "trimha", "trimhb", "morem",
              "morea", "morey", "mored", "moreha", "morehb", "avail",
              "overflow", "waves")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def build(platform: str) -> pathlib.Path:
    """Compile the wave library for `platform` ("cpu" or "cuda") unless an
    up-to-date build exists; returns the shared library's path."""
    src = _NATIVE / _SOURCES[platform]
    so = _BUILD / f"libwave_{platform}.so"
    newest = max(src.stat().st_mtime,
                 (_NATIVE / "wave_lane.h").stat().st_mtime)
    if so.exists() and so.stat().st_mtime >= newest:
        return so
    _BUILD.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    common = ["-std=c++17", "-O3", "-shared", "-I", jax.ffi.include_dir(),
              "-I", str(_NATIVE), "-o", str(tmp), str(src)]
    if platform == "cuda":
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-Xcompiler", "-fPIC"] + common
    else:
        cmd = ["g++", "-fPIC"] + common
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"building {src.name} failed:\n{r.stderr}")
    os.replace(tmp, so)
    return so


_registered: set = set()


def register(platform: str) -> None:
    """Build and register the FFI target for `platform` once per process."""
    if platform in _registered:
        return
    lib = ctypes.cdll.LoadLibrary(str(build(platform)))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.DamapperWave),
        platform="CUDA" if platform == "cuda" else "cpu")
    _registered.add(platform)


def wave_pass(lanes, Aflat, Bflat, table, score, params, *, pool_rows: int,
              reverse: bool, band: int):
    """One forward or reverse pass over (n, 6) int32 lanes
    [abase, bbase, mida, k0, aoffp, boffp].  Returns the (n, 14) per-lane
    outputs (OUT_FIELDS) and the (n, pool_rows, 4) pebble pool."""
    if band not in BANDS:
        raise ValueError(f"band must be one of {BANDS}, got {band}")
    n = lanes.shape[0]
    return jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((n, len(OUT_FIELDS)), jnp.int32),
         jax.ShapeDtypeStruct((n, pool_rows, 4), jnp.int32)),
    )(lanes, Aflat, Bflat, table, score, params,
      reverse=np.int32(reverse), band=np.int32(band))


def ffi_platform(platform: str) -> str:
    """The FFI platform serving a JAX device platform."""
    if platform == "gpu":
        return "cuda"
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"no wave kernel for platform {platform!r}")


class KernelWaveEngine(WaveEngine):
    """WaveEngine whose passes run the wave kernel.  Lanes are independent
    and each runs to completion in one launch, so batches are launched
    whole (up to BUCKET lanes) instead of in small lockstep chunks."""

    BUCKET = 1 << 14
    # rounds smaller than this go to the host oracle: measured on an H100,
    # a one-lane launch (with its pull and trace walk) takes about half the
    # oracle's time for the same lane, so every round stays on the card
    HOST_MIN = 0

    def __init__(self, spec, band_cap: int = 128, pool_cap: int = 2048,
                 mesh=None, platform: str | None = None):
        super().__init__(spec, band_cap=band_cap, pool_cap=pool_cap,
                         mesh=mesh)
        if platform is None:
            platform = jax.devices()[0].platform
        self._ffi = ffi_platform(platform)
        register(self._ffi)
        if mesh is not None:
            self._ndp = mesh.size
        self._consts = (jnp.asarray([spec.trace_space, spec.ave_path],
                                    jnp.int32),
                        jnp.asarray(spec.table, jnp.int16),
                        jnp.asarray(spec.score, jnp.int16))

    def _get_fns(self, P: int):
        if P not in self._fns:
            self._fns[P] = (self._mk(P, False), self._mk(P, True))
        return self._fns[P]

    def _mk(self, P: int, reverse: bool):
        W = self.W

        def fn(abase, bbase, mida, k0, aoffp, boffp, Aflat, Bflat, params,
               table, score):
            lanes = jnp.stack([abase, bbase, mida, k0, aoffp, boffp], axis=1)
            out, pool = wave_pass(lanes, Aflat, Bflat, table, score, params,
                                  pool_rows=P, reverse=reverse, band=W)
            res = {f: out[:, i] for i, f in enumerate(OUT_FIELDS)}
            res["overflow"] = res["overflow"] != 0
            res["pool"] = pool
            return res

        return jax.jit(shard_lanes(fn, self.mesh, n_lane_args=6,
                                   n_args=11))

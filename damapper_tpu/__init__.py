"""damapper_tpu — a long-read mapper on accelerators, in JAX.

A from-scratch reimplementation of the capabilities of Gene Myers' DAMAPPER
(reference: thegenemyers/DAMAPPER):

  * data plane      — DAZZ .db/.dam/.las codecs -> columnar numpy/JAX arrays
                      (damapper_tpu.io, parity with reference DB.c / align.c I/O)
  * k-mer index     — vectorized extraction + device sort (damapper_tpu.ops.kmers)
  * seed matching   — sort-merge intersection (damapper_tpu.ops.seeds)
  * chaining        — sweep chain DP (damapper_tpu.ops.chain, native C++ fast path)
  * wave alignment  — O(nd) trace-point wave (damapper_tpu.ops.wave oracle,
                      damapper_tpu.ops.wave_kernel CUDA kernel and its
                      host build)
  * reporting       — LA fusion/chain-graph/zone selection + .las emission
                      (damapper_tpu.pipeline.reporter)
  * distribution    — jax.sharding mesh plans replacing HPC.damapper scripts
                      (damapper_tpu.parallel)
"""

import os as _os

# numpy madvises MADV_HUGEPAGE on >=4MB arrays; with the kernel's THP
# defrag mode "madvise" each 2MB first-touch then runs synchronous
# compaction that can fail anyway (AnonHugePages stays 0), making cold
# buffer faults up to ~50x slower than plain pages (measured 54ms vs
# 2.6s to first-touch 96MB on the bench VM).  Index/wave scratch buffers
# are hundreds of MB, so turn the hint off at runtime (numpy is often
# preloaded by site hooks, so the NUMPY_MADVISE_HUGEPAGE env var set here
# would be read too late).  NUMPY_MADVISE_HUGEPAGE=1 restores the hint.
if _os.environ.get("NUMPY_MADVISE_HUGEPAGE") != "1":
    from numpy._core import multiarray as _ma
    _ma._set_madvise_hugepage(False)

__version__ = "0.1.0"

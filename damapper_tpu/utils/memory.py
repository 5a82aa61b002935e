"""One memory budget rule: a size is a share of the memory of the device
the arrays live on (host RAM on the CPU)."""

from __future__ import annotations

import os


def physical_memory() -> int:
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def device_memory(device=None) -> int:
    """Bytes an allocator may hand out on `device` (default: the first JAX
    device).  A device that reports no limit is an error, not a guess."""
    import jax

    dev = jax.devices()[0] if device is None else device
    if dev.platform == "cpu":
        return physical_memory()
    stats = dev.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(f"device {dev.device_kind!r} reports no memory "
                           f"limit; cannot size device buffers")
    return int(stats["bytes_limit"])


def device_share(fraction: float, device=None) -> int:
    return int(fraction * device_memory(device))

"""Process-level runtime setup shared by the CLI, bench.py and chip_smoke.py:
the persistent compile cache, and the card identity every measurement is
reported with."""

from __future__ import annotations

import os
import subprocess

# Fixed path inside the checkout: JAX keys its persistent cache by path, so a
# directory that moves between runs never hits.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at CACHE_DIR, unless
    JAX_COMPILATION_CACHE_DIR is set — JAX reads that variable itself, and
    then no other directory is set here. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """`name, power.limit` CSV lines (no header) -> [(name, power_limit)]."""
    cards = []
    for line in text.splitlines():
        if not line.strip():
            continue
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def card_identity() -> str:
    """The raw `nvidia-smi --query-gpu=name,power.limit` lines, one per card;
    raises if nvidia-smi is missing or fails (a number must name its card)."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    parse_nvidia_smi(out)
    return out


def require_gpu():
    """The first JAX device, which must be a GPU: a measurement path that
    finds no card fails instead of running on the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform} "
                         f"({dev.device_kind})")
    return dev

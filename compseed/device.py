"""The device the program runs on, and the guard against running elsewhere.

The device path is written for an NVIDIA GPU.  A run that lands on
another backend is an error, not a slow success, unless the CPU was
asked for explicitly with ``JAX_PLATFORMS=cpu`` (how the tests run).
"""

from __future__ import annotations

import os
import subprocess


def require_gpu(what: str) -> str:
    """Return JAX's backend; raise RuntimeError unless it is the GPU or
    the CPU was requested explicitly."""
    import jax
    backend = jax.default_backend()
    asked = os.environ.get("JAX_PLATFORMS", "").split(",")[0].strip()
    if backend == "gpu" or (backend == "cpu" and asked == "cpu"):
        return backend
    raise RuntimeError(
        f"{what}: JAX's backend is {backend!r}, not 'gpu' (set "
        "JAX_PLATFORMS=cpu to run on the CPU on purpose)")


def parse_card(line: str) -> tuple[str, str]:
    """(name, power limit) from one line of ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader``."""
    name, _, limit = line.strip().rpartition(",")
    if not name or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line: {line!r}")
    return name.strip(), limit.strip()


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi reports
    them (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    name, limit = parse_card(out.splitlines()[0])
    return f"{name}, {limit}"


def local_card_count() -> int:
    """Number of NVIDIA cards on this host (0 without nvidia-smi), read
    without starting a device backend."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))

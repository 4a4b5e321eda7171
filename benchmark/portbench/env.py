"""The run's process: its start time, its environment, the card it runs on,
and the modules it must not hold."""

from __future__ import annotations

import os
import sys
import time
from typing import List

from .files import ROOT

# top-level module names that no run may load: JAX, its libraries, and the JAX
# package (compared whole: openvivqa_tpu_torch begins with openvivqa_tpu)
FORBIDDEN = ("jax", "jaxlib", "flax", "openvivqa_tpu")
# fixed cache directories inside the checkout (build/ is ignored by git), so
# that only the first run of a checkout builds and compiles
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": ROOT / "build" / "portbench_cache" / "torch_extensions",
    "TRITON_CACHE_DIR": ROOT / "build" / "portbench_cache" / "triton",
}


def process_start() -> float:
    """The wall-clock time this process started (from /proc), so that set-up
    counts the interpreter's own start and every import."""
    try:
        with open("/proc/self/stat") as handle:
            fields = handle.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as handle:
            uptime = float(handle.read().split()[0])
        started = float(fields[19]) / os.sysconf("SC_CLK_TCK")  # field 22 of stat
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()


def prepare() -> None:
    """Environment for the port and the libraries it loads, before torch is
    imported: no JAX through transformers, random backbones allowed (no
    pretrained file is in the repository), caches inside the checkout."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["OPENVIVQA_ALLOW_RANDOM_BACKBONE"] = "1"
    for key, path in CACHE_DIRS.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    if str(ROOT) not in sys.path:
        sys.path.insert(1, str(ROOT))


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def require_cards(count: int) -> str:
    """The cards' name; RuntimeError unless `count` CUDA devices are there.
    A measurement never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark measures the port on the card only")
    if torch.cuda.device_count() < count:
        raise RuntimeError(f"the cell needs {count} CUDA devices, "
                           f"{torch.cuda.device_count()} are visible")
    return torch.cuda.get_device_name(0)

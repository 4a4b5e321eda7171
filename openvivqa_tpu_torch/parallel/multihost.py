"""Multi-process runtime helpers, the port's counterpart of
``openvivqa_tpu/parallel/multihost.py``.

``initialize()`` starts ``torch.distributed`` from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):
NCCL for a CUDA device, gloo for the CPU.  ``gather_eval_dicts`` merges each
process's generation and ground-truth dicts onto every process before the
host-side metrics.  Without a process group every helper answers for one
process.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..logging_utils import setup_logger

logger = setup_logger()


def initialize(device="cuda", backend: Optional[str] = None, required: bool = False) -> None:
    """``init_process_group`` from the environment when ``WORLD_SIZE`` > 1 is
    set (or is set at all, with `required`: a one-process run under a
    ``TRAINING.MESH``); a no-op otherwise and once a group exists.  On a CUDA
    device the process takes ``cuda:LOCAL_RANK`` first.  `backend` defaults to
    NCCL on CUDA and gloo on the CPU."""
    world = os.environ.get("WORLD_SIZE")
    if dist.is_initialized() or world is None or (int(world) <= 1 and not required):
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method="env://")
    logger.info("torch.distributed initialised (%s): process %d/%d", dist.get_backend(),
                dist.get_rank(), dist.get_world_size())


def finalize() -> None:
    """Destroy the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def gather_eval_dicts(gts: Dict, gens: Dict) -> Tuple[Dict, Dict]:
    """Every process's (gts, gens) merged onto every process; one process:
    its input unchanged.  The merge keeps the RAW keys, with no process
    prefix: callers key by global sample id (``BaseTask.eval_key``), so the
    batches that the loader's wrap-padding repeats at an uneven tail land on
    the same key and are scored once."""
    if process_count() == 1:
        return gts, gens
    pairs = [None] * process_count()
    dist.all_gather_object(pairs, (gts, gens))
    merged_gts, merged_gens = {}, {}
    for host_gts, host_gens in pairs:
        merged_gts.update(host_gts)
        merged_gens.update(host_gens)
    return merged_gts, merged_gens

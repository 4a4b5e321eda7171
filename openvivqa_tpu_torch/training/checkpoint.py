"""Checkpoint save, load and promotion, the port's counterpart of
``openvivqa_tpu/training/checkpoint.py``.

One ``last_model.pth`` per model directory, written with ``torch.save``: the
model's and the optimizer's state dicts, the schedule's, the task's metadata
(epoch, best score, patience, the task generator's state) and the numpy RNG
state.  The write goes to ``<path>.tmp`` first and replaces the file with
``os.replace``, so a crash mid-save leaves the previous checkpoint whole.
``best_model.pth`` is a copy of the last one, made when the dev score
improves; a run resumes when ``last_model.pth`` is present.  Only the primary
process writes.  Under FSDP the task gathers the full state first
(:func:`full_state`), so the file is the one a single process writes, and a
resume shards it again (:func:`load_full_state`).

``OPENVIVQA_CKPT_BACKEND=orbax`` selects the sharded backend (the JAX
package's orbax one): every process writes its shards of the model and the
optimizer into the sibling directory ``<path>.dcp`` with
``torch.distributed.checkpoint``, and the ``.pth`` holds the host metadata
only.  Promotion copies the directory too.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.multihost import is_primary

LAST_NAME = "last_model.pth"
BEST_NAME = "best_model.pth"


def sharded_backend() -> bool:
    return os.environ.get("OPENVIVQA_CKPT_BACKEND", "torch").lower() == "orbax"


def sharded_dir(path: str) -> str:
    return os.path.abspath(path + ".dcp")


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """The payload (with the numpy RNG state) to `path`, by the primary
    process only.  A payload holding the model removes a stale ``.dcp``
    sibling, which would otherwise shadow it on the next load."""
    if not is_primary():
        return
    tmp_path = path + ".tmp"
    torch.save({**payload, "numpy_rng_state": np.random.get_state()}, tmp_path)
    os.replace(tmp_path, path)
    if "model" in payload and os.path.isdir(sharded_dir(path)):
        shutil.rmtree(sharded_dir(path))


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """The payload, its tensors on the CPU, with the numpy RNG state restored;
    None when there is no file.  The file holds numpy arrays beside tensors,
    so it is read with ``weights_only=False``: load only checkpoints this
    program wrote."""
    if not os.path.exists(path):
        return None
    payload = torch.load(path, map_location="cpu", weights_only=False)
    np.random.set_state(payload.pop("numpy_rng_state"))
    return payload


def promote(src_path: str, dst_path: str) -> None:
    """Best-model promotion by file copy (and of the ``.dcp`` directory of
    the sharded backend), by the primary process only."""
    if is_primary():
        shutil.copyfile(src_path, dst_path)
        if os.path.isdir(sharded_dir(src_path)):
            if os.path.isdir(sharded_dir(dst_path)):
                shutil.rmtree(sharded_dir(dst_path))
            shutil.copytree(sharded_dir(src_path), sharded_dir(dst_path))
    _barrier()


# -- FSDP: the full state of a sharded model ---------------------------------------------
def _options(**kwargs):
    from torch.distributed.checkpoint.state_dict import StateDictOptions

    return StateDictOptions(**kwargs)


def full_state(root: torch.nn.Module, optimizer, names: List[str]):
    """(model state, optimizer state) of an FSDP `root` (a ``TrainForward``:
    its parameter names start with ``model.``) gathered whole onto the
    primary's CPU, in a single process's layout: the model's own parameter
    names, and the optimizer's parameters by their index in `names`.  Every
    process must call it; the others get empty dicts."""
    from torch.distributed.checkpoint.state_dict import (
        get_model_state_dict,
        get_optimizer_state_dict,
    )

    options = _options(full_state_dict=True, cpu_offload=True)
    model = get_model_state_dict(root, options=options)
    optim = get_optimizer_state_dict(root, optimizer, options=options)
    if not is_primary():
        return {}, {}
    index = {f"model.{name}": i for i, name in enumerate(names)}
    return ({key[len("model."):]: value for key, value in model.items()}, {
        "state": {index[key]: value for key, value in optim["state"].items()},
        "param_groups": [{**group, "params": [index[key] for key in group["params"]]}
                         for group in optim["param_groups"]],
    })


def load_full_state(root: torch.nn.Module, optimizer, names: List[str], model_state,
                    optim_state) -> None:
    """Shard a single process's model and optimizer state (as
    :func:`full_state` returns them) onto the FSDP `root`."""
    from torch.distributed.checkpoint.state_dict import (
        set_model_state_dict,
        set_optimizer_state_dict,
    )

    options = _options(full_state_dict=True)
    set_model_state_dict(root, {f"model.{key}": value for key, value in model_state.items()},
                         options=options)
    set_optimizer_state_dict(root, optimizer, {
        "state": {f"model.{names[i]}": value for i, value in optim_state["state"].items()},
        "param_groups": [{**group, "params": [f"model.{names[i]}" for i in group["params"]]}
                         for group in optim_state["param_groups"]],
    }, options=options)


# -- the sharded backend -----------------------------------------------------------------
def _sharded_state(root: torch.nn.Module, optimizer) -> Dict[str, Any]:
    from torch.distributed.checkpoint.state_dict import (
        get_model_state_dict,
        get_optimizer_state_dict,
    )

    return {"model": get_model_state_dict(root),
            "optimizer": get_optimizer_state_dict(root, optimizer)}


def save_sharded(path: str, root: torch.nn.Module, optimizer, host: Dict[str, Any]) -> None:
    """Every process writes its shards of `root`'s model and optimizer state
    to ``<path>.dcp`` (through a temporary directory swapped in, so that a
    crash mid-save leaves the previous one whole); then the primary writes the
    host payload to `path`."""
    import torch.distributed.checkpoint as dcp

    target = sharded_dir(path)
    tmp, old = target + ".tmp", target + ".old"
    if is_primary():
        for leftover in (tmp, old):
            if os.path.isdir(leftover):
                shutil.rmtree(leftover)
    _barrier()
    dcp.save(_sharded_state(root, optimizer), checkpoint_id=tmp)
    _barrier()
    if is_primary():
        if os.path.isdir(target):
            os.rename(target, old)
        os.rename(tmp, target)
        if os.path.isdir(old):
            shutil.rmtree(old)
    save_checkpoint(path, host)
    _barrier()


def load_sharded(path: str, root: torch.nn.Module, optimizer) -> None:
    """Read ``<path>.dcp`` into `root` and `optimizer`, each process its own
    shards (whatever the layout that wrote them)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import (
        set_model_state_dict,
        set_optimizer_state_dict,
    )

    state = _sharded_state(root, optimizer)
    dcp.load(state, checkpoint_id=sharded_dir(path))
    set_model_state_dict(root, state["model"])
    set_optimizer_state_dict(root, optimizer, state["optimizer"])

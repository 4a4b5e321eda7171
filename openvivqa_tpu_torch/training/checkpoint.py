"""Checkpoint save, load and promotion, the port's counterpart of
``openvivqa_tpu/training/checkpoint.py``.

One ``last_model.pth`` per model directory, written with ``torch.save``: the
model's and the optimizer's state dicts, the schedule's, the task's metadata
(epoch, best score, patience, the task generator's state) and the numpy RNG
state.  The write goes to ``<path>.tmp`` first and replaces the file with
``os.replace``, so a crash mid-save leaves the previous checkpoint whole.
``best_model.pth`` is a copy of the last one, made when the dev score
improves; a run resumes when ``last_model.pth`` is present.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

LAST_NAME = "last_model.pth"
BEST_NAME = "best_model.pth"


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    tmp_path = path + ".tmp"
    torch.save({**payload, "numpy_rng_state": np.random.get_state()}, tmp_path)
    os.replace(tmp_path, path)


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
    """Best-model promotion by file copy."""
    shutil.copyfile(src_path, dst_path)

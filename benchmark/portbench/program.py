"""The system under test: the port's task built from a configuration file on
the benchmark's generated split, with the benchmark's weights."""

from __future__ import annotations

import math
import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Mapping, Tuple

import torch

from .files import BENCH, load_module

WEIGHT_STD = 0.02


def nested(flat: Mapping) -> Dict:
    """The configuration file's dotted keys as the nested dict the port
    reads; keys starting with "_" are the file's notes."""
    out: Dict = {}
    for key, value in flat.items():
        if key.startswith("_"):
            continue
        node = out
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def data_dir(cell: str, seed: int) -> Path:
    """Where a run writes its split: under TMPDIR, by cell and seed."""
    return Path(tempfile.gettempdir()) / "portbench" / cell / str(seed)


def generator(traffic: Mapping):
    """The data generator a traffic mix names: ``benchmark/data/<name>.py``."""
    name = traffic["generator"]
    return load_module(BENCH / "data" / f"{name}.py", f"data.{name}")


def write_split(cell: str, traffic: Mapping, seed: int) -> Dict[str, str]:
    """Write the cell's split, then flush it to disk: the kernel's writeback
    of the split's dirty pages would otherwise land in the measured window
    (the loader reads the files from the page cache either way)."""
    root = data_dir(cell, seed)
    shutil.rmtree(root, ignore_errors=True)
    paths = generator(traffic).generate(str(root), traffic, seed)
    os.sync()
    return paths


def remove_split(cell: str, seed: int) -> None:
    shutil.rmtree(data_dir(cell, seed), ignore_errors=True)


def run_config(flat: Mapping, traffic: Mapping, paths: Mapping[str, str], seed: int,
               checkpoint: str) -> Dict:
    """The nested configuration of one run: the file's, pointed by the mix's
    generator at the split written to `paths`, seeded by `seed`."""
    keys = {**flat, **generator(traffic).config_keys(paths),
            "TRAINING.SEED": int(seed), "TRAINING.CHECKPOINT_PATH": checkpoint}
    return nested(keys)


def build_task(config: Dict, device: str):
    from openvivqa_tpu_torch.builders import build_task as port_build_task
    from openvivqa_tpu_torch.builders import populate
    from openvivqa_tpu_torch.config import ConfigNode

    populate()
    return port_build_task(ConfigNode(config), device)


def weight_seed(seed: int) -> int:
    return (int(seed) * 1_000_003 + 17) % (1 << 63)


def draw_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Weights by parameter name, drawn on `device` from `seed` in one call of
    a generator there, float32 (the type the port holds and trains them in):
    N(0, 0.02) for matrices and tables and for biases, 1 + N(0, 0.02) for the
    LayerNorm scales (1-D parameters named "weight").  Names are taken in
    sorted order, so any module order draws the same values."""
    shapes = sorted((name, tuple(shape)) for name, shape in shapes)
    generator = torch.Generator(device=device)
    generator.manual_seed(weight_seed(seed))
    sizes = [math.prod(shape) for _, shape in shapes]
    flat = torch.randn(sum(sizes), generator=generator, device=device).mul_(WEIGHT_STD)
    out, offset = {}, 0
    for (name, shape), size in zip(shapes, sizes):
        value = flat[offset:offset + size].view(shape)
        offset += size
        if len(shape) == 1 and name.rsplit(".", 1)[-1] == "weight":
            value = value + 1.0
        out[name] = value
    return out


def model_shapes(model: torch.nn.Module):
    return [(name, tuple(p.shape)) for name, p in model.named_parameters()]


@torch.no_grad()
def load_weights(model: torch.nn.Module, seed: int) -> None:
    """The benchmark's weights into the port's model, in place (the task's
    optimizer holds these very tensors)."""
    device = next(model.parameters()).device
    weights = draw_weights(model_shapes(model), seed, device)
    for name, param in model.named_parameters():
        param.copy_(weights[name])


# a host batch's fields that name its samples and the program's answers to
# them; the reference reads the features again from the split's files
KEPT_FIELDS = ("image_id", "question_id", "question", "answer", "answers", "ocr_tokens",
               "question_tokens", "answer_tokens", "shifted_right_answer_tokens",
               "sample_valid")


def host_fields(batch) -> Dict:
    """What the reference needs of a host batch (the loader makes new arrays
    for every batch, so nothing is copied)."""
    return {key: batch[key] for key in KEPT_FIELDS if key in batch}


def checkpoint_dir(cell: str, seed: int) -> str:
    return os.path.join(str(data_dir(cell, seed)), "checkpoints")

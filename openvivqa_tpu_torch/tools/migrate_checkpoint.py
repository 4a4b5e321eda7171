"""Migrate a reference (torch) checkpoint into the port's task format, the
port's counterpart of ``openvivqa_tpu/tools/migrate_checkpoint.py``.

Users with trained ``last_model.pth`` / ``best_model.pth`` files of the PyTorch
reference (a ``torch.save`` dict with ``state_dict``, ``epoch``,
``best_val_score``, ...) convert them in place:

    python -m openvivqa_tpu_torch.tools.migrate_checkpoint \\
        --config config.yaml --checkpoint /path/to/best_model.pth [--device cpu]

This builds the task from the config (so vocab, datasets and model match what
training will use), maps the weights onto the model for a supported
architecture (:data:`MODEL_CONVERTERS`), checks every parameter's name and
shape against the freshly built model, and writes a resumable
``last_model.pth`` in the task's checkpoint directory with a fresh optimizer
state.  ``--also-best`` also writes ``best_model.pth``, which evaluation-only
runs read.

The port's modules carry the reference's parameter names for every
architecture the table supports (``models/convert.py``), so the mapping is by
name; a reference key the model does not hold (a buffer such as HF's
``position_ids``) is left out, as the JAX converters leave it.

Reference BERT stacks use the HF default intermediate size (3072) whatever
HIDDEN_SIZE is: for checkpoints trained at hidden != 768 set
``MMT.INTERMEDIATE_SIZE: 3072`` (and ``TEXT_BERT.INTERMEDIATE_SIZE``); the
shape check names the mismatching parameters otherwise.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Mapping, Optional, Sequence

import torch


# the JAX package's table (openvivqa_tpu/models/modules/torch_conversion.py):
# True for an architecture whose reference checkpoints migrate, a string for a
# refusal, with the same reasons word for word
MODEL_CONVERTERS: Dict[str, Any] = {
    "IterativeMCAN": True,
    "ReadableIterativeMCAN": True,
    "MCAN": True,
    "SAAA": True,
    "MMF_M4C": True,
    "MMF_ImprovedDecodingM4C": True,
    "MMF_REGIONAL_M4C": True,
    "MMF_IterativeM4C": True,
    "MMF_Iterative_Multilevel_M4C": True,
    "MMF_LanguageAdaptiveM4C": True,
    "JointTransformer": True,
    "M4C": True,
    "MMF_LoRRA": True,
    "MMF_IterativeLoRRA": (
        "the reference MMF_IterativeLoRRA cannot be constructed at all: "
        "_build_mmt resolves its branch configs through build_ENCODER "
        "(mmf_iterative_lorra.py:66-68) whose registry has no "
        "'ScaledDotProductAttention' entry — __init__ raises before any "
        "parameter exists, so no checkpoints can exist to migrate; this "
        "framework's faithful rebuild (models/mmf_lorra.py) trains fresh"
    ),
    "MMF_SAL": (
        "the reference MMF_SAL (mmf_sal.py:44-88) encodes questions with "
        "an HF text-embedding wrapper over raw strings (not TextBert over "
        "vocab ids) and carries dead ocr_word_embedding/"
        "ocr_text_layer_norm modules its forward never uses; this "
        "framework's MMF_SAL implements the intended extra OCR "
        "word-embedding stream, so the parameter sets do not correspond. "
        "No reference config names MMF_SAL, so no upstream training "
        "pipeline (and no checkpoints) exists for it"
    ),
    "experimental_MMF_M4C": (
        "the reference experimental_MMF_M4C cannot be constructed at all: "
        "its MMT calls build_encoder for ARCHITECTURE 'MultiModalEncoder' "
        "(experimental_mmf_m4c.py:272, configs/experimental_mmf_m4c.yaml:"
        "104), a name registered NOWHERE in the reference — __init__ "
        "raises before any parameter exists, so no checkpoints can exist "
        "to migrate; train fresh with this framework's variant"
    ),
}


def convert_reference_checkpoint(checkpoint: Mapping[str, Any], config,
                                 model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters of `model` (built from `config`, the MODEL node) taken
    from a reference ``torch.load(...)`` dict (its ``state_dict``) or a raw
    state dict, by name; raises NotImplementedError for an architecture the
    table refuses or lacks."""
    state_dict = checkpoint.get("state_dict", checkpoint)
    name = config.ARCHITECTURE
    if name not in MODEL_CONVERTERS:
        raise NotImplementedError(
            f"no converter for {name}; supported: {sorted(MODEL_CONVERTERS)}"
        )
    if MODEL_CONVERTERS[name] is not True:
        raise NotImplementedError(
            f"no checkpoint converter for {name}: {MODEL_CONVERTERS[name]}"
        )
    names = {key for key, _ in model.named_parameters()}
    return {key: torch.as_tensor(value) for key, value in state_dict.items() if key in names}


def check_against_model(converted: Mapping[str, torch.Tensor], model: torch.nn.Module) -> None:
    """Every parameter of `model` present in `converted` (which holds no other
    key) with its shape: the JAX tool's two errors."""
    want_map = {key: tuple(p.shape) for key, p in model.named_parameters()}
    got_map = {key: tuple(value.shape) for key, value in converted.items()}
    missing = sorted(set(want_map) - set(got_map))[:5]
    if missing:
        raise ValueError(
            f"converted tree does not match the model built from the config; "
            f"missing: {missing}"
        )
    mismatched = [key for key in want_map if want_map[key] != got_map[key]]
    if mismatched:
        detail = {k: (want_map[k], got_map[k]) for k in mismatched[:5]}
        raise ValueError(f"shape mismatches (model vs checkpoint): {detail}")


def migrate(config, torch_checkpoint: str, also_best: bool = False, device="cuda") -> str:
    """Build the task of `config` on `device`, load the reference checkpoint's
    weights into its model and write a resumable ``last_model.pth`` (with the
    reference's epoch, best score, patience and RL flag); its path."""
    from ..builders import build_task, populate
    from ..logging_utils import setup_logger
    from ..training.checkpoint import BEST_NAME, LAST_NAME, promote

    logger = setup_logger()
    populate()
    task = build_task(config, device)

    checkpoint = torch.load(torch_checkpoint, map_location="cpu", weights_only=False)
    converted = convert_reference_checkpoint(checkpoint, config.MODEL, task.model)
    check_against_model(converted, task.model)
    task.model.load_state_dict({**task.model.state_dict(), **converted})

    task.epoch = int(checkpoint.get("epoch", 0))
    task.save_checkpoint({
        "best_val_score": float(checkpoint.get("best_val_score", -1.0)),
        "patience": int(checkpoint.get("patience", 0)),
        "use_rl": bool(checkpoint.get("use_rl", False)),
    })
    last = os.path.join(task.checkpoint_path, LAST_NAME)
    logger.info("Wrote migrated checkpoint to %s (epoch %d)", last, task.epoch)
    if also_best:
        best = os.path.join(task.checkpoint_path, BEST_NAME)
        promote(last, best)
        logger.info("Copied to %s", best)
    return last


def main(argv: Optional[Sequence[str]] = None) -> None:
    from ..config import get_config

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, help="task YAML config")
    parser.add_argument("--checkpoint", required=True, help="reference torch .pth file")
    parser.add_argument("--also-best", action="store_true",
                        help="also write best_model.pth (for evaluation-only runs)")
    parser.add_argument("--device", default="cuda",
                        help="device of the task the checkpoint is written from (default: cuda)")
    args = parser.parse_args(argv)
    migrate(get_config(args.config), args.checkpoint, also_best=args.also_best,
            device=args.device)


if __name__ == "__main__":
    main()

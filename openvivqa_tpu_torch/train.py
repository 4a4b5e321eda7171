"""Command line entry point of the port: train a config, then predict the test
split from the best checkpoint.

    python -m openvivqa_tpu_torch.train --config-file configs/mmf_m4c.yaml \
        [--opts KEY.SUBKEY=VALUE ...] [--eval-only] [--device cuda|cpu]

Under torchrun every process takes ``cuda:LOCAL_RANK`` and trains its share of
each global batch (DDP; ``TRAINING.MESH.FSDP=true`` shards the model):

    torchrun --nproc_per_node N -m openvivqa_tpu_torch.train \
        --config-file configs/mmf_m4c.yaml --opts TRAINING.MESH.FSDP=true
"""

from __future__ import annotations

import argparse
import os

import yaml

from .builders import build_task, populate
from .config import get_config
from .logging_utils import setup_logger
from .parallel import multihost


def _parse_opts(pairs):
    """KEY.SUBKEY=value overrides, each value read as YAML."""
    overrides = {}
    for pair in pairs or []:
        key, _, value = pair.partition("=")
        node = overrides
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = yaml.safe_load(value)
    return overrides


def main(argv=None):
    logger = setup_logger()
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", type=str, required=True)
    parser.add_argument("--opts", nargs="*", default=None)
    parser.add_argument("--eval-only", action="store_true",
                        help="skip training; predict the test split from the existing "
                        "best_model.pth")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model and its kernels (default: cuda)")
    args = parser.parse_args(argv)

    populate()
    config = get_config(args.config_file, _parse_opts(args.opts))
    device = args.device
    if device == "cuda" and "LOCAL_RANK" in os.environ:
        device = f"cuda:{os.environ['LOCAL_RANK']}"
    multihost.initialize(device, required=bool(config.TRAINING.get("MESH")))
    task = build_task(config, device)
    if not args.eval_only:
        task.start()
    task.get_predictions()
    logger.info("Task done.")
    multihost.finalize()


if __name__ == "__main__":
    main()

"""Command line entry point of the port: train a config, then predict the test
split from the best checkpoint.

    python -m openvivqa_tpu_torch.train --config-file configs/mmf_m4c.yaml \
        [--opts KEY.SUBKEY=VALUE ...] [--eval-only] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import yaml

from .builders import build_task, populate
from .config import get_config
from .logging_utils import setup_logger


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
    task = build_task(config, args.device)
    if not args.eval_only:
        task.start()
    task.get_predictions()
    logger.info("Task done.")


if __name__ == "__main__":
    main()

"""Base task, eval part: vocab, datasets and loaders through the shared host
layers, the model on an explicit device, weights from a seed or from a flax
tree, and host-to-device batch transfer.

Counterpart of the eval responsibilities of
``openvivqa_tpu/training/tasks/base_task.py``.  Training, optimizers and
checkpoints belong to the training slice (ROADMAP).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from openvivqa_tpu.data.loader import DataLoader
from openvivqa_tpu.logging_utils import setup_logger
from openvivqa_tpu.utils.instance import Batch

from ...builders import build_dataset, build_model, build_vocab
from ...models.convert import params_from_flax
from ...models.modules.bert import init_jax_law_

logger = setup_logger()


class BaseTask:
    def __init__(self, config, device, params: Optional[Mapping[str, Any]] = None):
        self.config = config
        self.device = torch.device(device)
        self.vocab = build_vocab(config.DATASET.VOCAB)
        self.load_datasets(config.DATASET)
        self.create_dataloaders(config)
        logger.info("Building model on %s", self.device)
        self.model = self.build_model(params).to(self.device).eval()

    def build_model(self, params: Optional[Mapping[str, Any]]):
        model = build_model(self.config.MODEL, self.vocab)
        if params is None:
            seed = int(self.config.TRAINING.get("SEED", 42))
            init_jax_law_(model, torch.Generator().manual_seed(seed))
        else:
            state = params_from_flax(params, self.config.MODEL)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        n_params = sum(p.numel() for p in model.parameters())
        logger.info("Model parameters: %.2fM", n_params / 1e6)
        return model

    def load_datasets(self, config):
        self.dev_dict_dataset = build_dataset(config.JSON_PATH.DEV, self.vocab, config.DICT_DATASET)

    def create_dataloaders(self, config):
        dd = config.DATASET.DICT_DATASET
        seed = int(config.TRAINING.get("SEED", 42))
        workers = dd.get("WORKERS", 4) or 1
        batch_size = max(1, dd.BATCH_SIZE // config.TRAINING.EVALUATING_BEAM_SIZE)

        # single process: no sharding, so the loader never asks jax
        self.dev_dict_dataloader = DataLoader(
            self.dev_dict_dataset, batch_size=batch_size, shuffle=False, num_workers=workers,
            seed=seed, process_shard=False,
        )

    def put_batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """The batch's arrays as tensors on the task's device."""
        return {
            key: torch.from_numpy(np.ascontiguousarray(value)).to(self.device, non_blocking=True)
            for key, value in batch.arrays().items()
        }

    def device_batches(self, dataloader, depth: int = 2) -> Iterator[Tuple[Batch, Dict]]:
        """Yield (host_batch, device_batch), `depth` batches ahead of the
        consumer so host-to-device copies are queued before they are needed."""
        iterator = iter(dataloader)
        queue: deque = deque()

        def fill() -> None:
            host = next(iterator, None)
            if host is not None:
                queue.append((host, self.put_batch(host)))

        for _ in range(max(1, depth)):
            fill()
        while queue:
            host, device_batch = queue.popleft()
            fill()
            yield host, device_batch

    @staticmethod
    def eval_key(batch, it: int, i: int) -> str:
        """Sample key for eval dicts: the question_id when present, else the
        (iteration, row) pair."""
        qids = batch.get("question_id")
        if qids is not None:
            return f"q{qids[i]}"
        return f"h0_{it}_{i}"

    def start(self):
        raise NotImplementedError(
            "training is not ported yet: ROADMAP queue 1, slice 1 'train'"
        )

    def get_predictions(self):
        raise NotImplementedError(
            "test predictions load a best checkpoint, which arrives with the "
            "training slice: ROADMAP queue 1, slice 1 'train'"
        )

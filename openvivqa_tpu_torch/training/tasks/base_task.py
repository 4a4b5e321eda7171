"""Base task: the vocab cached in the checkpoint directory, datasets and
loaders, the model on an explicit device, the optimizer and its schedule, the
seeded generator dropout draws from, host-to-device batch transfer, metrics
and checkpoints.

Counterpart of ``openvivqa_tpu/training/tasks/base_task.py``, the
pretrained-weights policy included (``models/modules/pretrained_loading.py``,
applied to every model it builds).  Device meshes,
FSDP and TRAINING.REMAT wait for multi-device training (ROADMAP queue 1).
"""

from __future__ import annotations

import json
import os
import pickle
import time
from collections import deque
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ...builders import build_model, build_vocab
from ...logging_utils import setup_logger
from ...models.convert import params_from_flax
from ...models.modules.bert import init_jax_law_
from ...models.modules.pretrained_loading import apply_pretrained_policy
from ...utils.instance import Batch
from ..checkpoint import LAST_NAME, load_checkpoint, save_checkpoint
from ..optim import make_optimizer, noam_lambda

logger = setup_logger()


class BaseTask:
    def __init__(self, config, device="cuda", params: Optional[Mapping[str, Any]] = None):
        self.config = config
        self.device = torch.device(device)
        self.checkpoint_path = os.path.join(config.TRAINING.CHECKPOINT_PATH, config.MODEL.NAME)
        os.makedirs(self.checkpoint_path, exist_ok=True)

        vocab_bin = os.path.join(self.checkpoint_path, "vocab.bin")
        if not os.path.isfile(vocab_bin):
            logger.info("Creating vocab")
            self.vocab = build_vocab(config.DATASET.VOCAB)
            with open(vocab_bin, "wb") as handle:
                pickle.dump(self.vocab, handle)
        else:
            logger.info("Loading vocab from %s", vocab_bin)
            with open(vocab_bin, "rb") as handle:
                self.vocab = pickle.load(handle)

        logger.info("Loading data")
        self.load_datasets(config.DATASET)
        self.create_dataloaders(config)

        logger.info("Building model on %s", self.device)
        self.model = self.build_model(params).to(self.device).eval()
        # every dropout of the training route draws from this generator, the
        # dropout kernels' seeds included; never from the global RNG
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(config.TRAINING.get("SEED", 42))
        )
        self.configuring_hyperparameters(config)
        self.optimizer, self.scheduler = make_optimizer(
            self.model.parameters(), config.TRAINING.LEARNING_RATE, self.lr_lambda()
        )
        self.epoch = 0

    # -- hooks -------------------------------------------------------------------
    def configuring_hyperparameters(self, config):
        raise NotImplementedError

    def load_datasets(self, config):
        raise NotImplementedError

    def create_dataloaders(self, config):
        raise NotImplementedError

    def lr_lambda(self):
        # extended_mcan_vlsp.yaml has no top-level D_MODEL: its model's width is
        # the fusion's, as ExtendedMCAN reads it
        model = self.config.MODEL
        d_model = model.get("D_MODEL") or model.MULTIMODAL_FUSION.D_MODEL
        return noam_lambda(d_model, self.config.TRAINING.WARMUP)

    # -- setup ---------------------------------------------------------------------
    def build_model(self, params: Optional[Mapping[str, Any]]):
        # the first train sample's feature widths, which flax infers from the data
        train = getattr(self, "train_dataset", None)
        example = train[0] if train is not None else None
        model = build_model(self.config.MODEL, self.vocab, example)
        if params is None:
            generator = torch.Generator().manual_seed(int(self.config.TRAINING.get("SEED", 42)))
            if hasattr(model, "init_weights_"):  # a model with initialisers of its own
                model.init_weights_(generator)
            else:  # the BERT family's law
                init_jax_law_(model, generator)
        else:
            state = params_from_flax(params, self.config.MODEL)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        # a config naming pretrained weights must resolve them locally (or
        # refuse), as the JAX task's apply_pretrained_policy does
        apply_pretrained_policy(self.config.MODEL, model, example)
        n_params = sum(p.numel() for p in model.parameters())
        logger.info("Model parameters: %.2fM", n_params / 1e6)
        return model

    def put_batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """The batch's arrays as tensors on the task's device.  With
        TRAINING.TRANSFER_DTYPE (e.g. bfloat16) float32 arrays cross to the
        device in that type, half the bytes, and are cast back to float32
        there."""
        transfer = self.config.TRAINING.get("TRANSFER_DTYPE")
        transfer = getattr(torch, transfer) if transfer else None
        out = {}
        for key, value in batch.arrays().items():
            tensor = torch.from_numpy(np.ascontiguousarray(value))
            cast = transfer is not None and tensor.dtype == torch.float32
            if cast:
                tensor = tensor.to(transfer)
            tensor = tensor.to(self.device, non_blocking=True)
            out[key] = tensor.float() if cast else tensor
        return out

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

    # -- observability ---------------------------------------------------------------
    def log_metrics(self, payload: Dict[str, Any]) -> None:
        """Append one JSON record to <checkpoint dir>/metrics.jsonl."""
        record = {"epoch": self.epoch, "time": time.time(), **payload}
        with open(os.path.join(self.checkpoint_path, "metrics.jsonl"), "a") as handle:
            handle.write(json.dumps(record, default=str) + "\n")

    def dump_json(self, filename: str, payload: Dict[str, Any]) -> None:
        with open(os.path.join(self.checkpoint_path, filename), "w+") as handle:
            json.dump(payload, handle, ensure_ascii=False)

    # -- checkpoints -------------------------------------------------------------------
    def save_checkpoint(self, extras: Dict[str, Any]) -> None:
        """last_model.pth: model, optimizer and schedule state, the generator's
        state (the dropout stream resumes exactly) and metadata."""
        save_checkpoint(os.path.join(self.checkpoint_path, LAST_NAME), {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "generator": self.generator.get_state(),
            "metadata": {"epoch": self.epoch, "step": self.scheduler.last_epoch, **extras},
        })

    def load_checkpoint(self, fname: str) -> Optional[Dict[str, Any]]:
        """Restore the state save_checkpoint wrote; its metadata, or None when
        there is no file."""
        payload = load_checkpoint(fname)
        if payload is None:
            return None
        logger.info("Loaded checkpoint from %s", fname)
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.scheduler.load_state_dict(payload["scheduler"])
        self.generator.set_state(payload["generator"])
        return payload["metadata"]

    def start(self):
        raise NotImplementedError

    def get_predictions(self):
        raise NotImplementedError

"""Base task: the vocab cached in the checkpoint directory, datasets and
loaders, the model on an explicit device, the optimizer and its schedule, the
seeded generator dropout draws from, host-to-device batch transfer, metrics
and checkpoints.

Counterpart of ``openvivqa_tpu/training/tasks/base_task.py``, the
pretrained-weights policy included (``models/modules/pretrained_loading.py``,
applied to every model it builds).  Scale-out follows the same keys:
TRAINING.MESH (or more than one process) lays the processes out on a (data,
model) mesh: with ``MESH.MODEL_PARALLEL`` > 1 the chosen weights are split over
``model`` (tensor parallelism), and the model is wrapped for training in DDP
over ``data``, or with ``MESH.FSDP`` sharded with FSDP2 (``parallel/mesh.py``);
every training loss is computed inside :meth:`BaseTask.train_forward`, and
eval reads whole weights inside :meth:`BaseTask.eval_weights`.  Each process
folds its data coordinate into the generator's seed (``SEED + data_index *
7919``, the JAX kernels' shard fold), so rank 0 draws the single-process
stream, the model ranks of one data group draw the same dropout masks and no
two data groups draw the same ones.  TRAINING.REMAT recomputes each layer's
activations in the backward (:func:`checkpoint_layers`).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import pickle
import time
from collections import deque
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ...builders import build_model, build_vocab
from ...logging_utils import setup_logger
from ...models.convert import params_from_flax
from ...models.modules.bert import init_jax_law_
from ...models.modules.pretrained_loading import apply_pretrained_policy
from ...parallel.mesh import (
    TrainForward,
    apply_tensor_parallel,
    average_gradients,
    data_count,
    data_index,
    data_shard,
    full_weights,
    get_mesh,
    get_mesh_2d,
    layer_modules,
    model_count,
    reached_parameters,
    whole_parameters,
    wrap_for_training,
)
from ...parallel.multihost import is_primary, process_count
from ...utils import tracing
from ...utils.instance import Batch
from ..checkpoint import (
    LAST_NAME,
    full_state,
    load_checkpoint,
    load_full_state,
    load_sharded,
    save_checkpoint,
    save_sharded,
    sharded_backend,
)
from ..optim import make_optimizer, noam_lambda

logger = setup_logger()

# each rank's generator seed is SEED + data_index * RANK_SEED_STRIDE, the fold by
# which each data shard of the JAX package's dropout kernel offsets its seed
# (openvivqa_tpu/ops/fused_attention.py: seed + axis_index("data") * 7919)
RANK_SEED_STRIDE = 7919


def _generator_contexts(generator: torch.Generator):
    """``checkpoint``'s context_fn: the recomputation draws from `generator`
    the state the forward started from, and leaves it where the forward left
    it.  (``preserve_rng_state`` restores only the global generators, and
    every dropout of the port draws from the task's own.)"""
    before = generator.get_state()

    @contextlib.contextmanager
    def recompute():
        after = generator.get_state()
        generator.set_state(before)
        try:
            yield
        finally:
            generator.set_state(after)

    return contextlib.nullcontext(), recompute()


def checkpoint_layers(model: torch.nn.Module, generator: torch.Generator) -> None:
    """TRAINING.REMAT: each layer of `model` (``parallel.mesh.layer_modules``)
    runs its forward under ``torch.utils.checkpoint`` whenever autograd
    records, so the backward recomputes its activations instead of keeping
    them, with the dropout masks and kernel seeds the forward drew from
    `generator`."""
    context_fn = functools.partial(_generator_contexts, generator)
    for layer in layer_modules(model):
        def remat_forward(*args, _forward=layer.forward, **kwargs):
            if not torch.is_grad_enabled():
                return _forward(*args, **kwargs)
            return checkpoint(_forward, *args, use_reentrant=False, context_fn=context_fn,
                              **kwargs)

        layer.forward = remat_forward


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
            if is_primary():  # whole or absent to the others, who build their own
                with open(vocab_bin + ".tmp", "wb") as handle:
                    pickle.dump(self.vocab, handle)
                os.replace(vocab_bin + ".tmp", vocab_bin)
        else:
            logger.info("Loading vocab from %s", vocab_bin)
            with open(vocab_bin, "rb") as handle:
                self.vocab = pickle.load(handle)

        logger.info("Loading data")
        self.load_datasets(config.DATASET)
        self.create_dataloaders(config)

        logger.info("Building model on %s", self.device)
        self.model = self.build_model(params).to(self.device).eval()
        self.setup_mesh(config.TRAINING.get("MESH"))
        # every dropout of the training route draws from this generator, the
        # dropout kernels' seeds included; never from the global RNG
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(config.TRAINING.get("SEED", 42)) + data_index(self.mesh) * RANK_SEED_STRIDE
        )
        if config.TRAINING.get("REMAT"):
            checkpoint_layers(self.model, self.generator)
        self.setup_parallel()
        self.configuring_hyperparameters(config)
        # after the wrap: tensor parallelism and FSDP replace the parameters
        # by DTensors; torch's foreach kernels take no mix of DTensors and
        # plain tensors, so a model axis steps Adam one parameter at a time
        self.optimizer, self.scheduler = make_optimizer(
            self.model.parameters(), config.TRAINING.LEARNING_RATE, self.lr_lambda(),
            foreach=False if self.tensor_parallel else None,
        )
        if self.tensor_parallel and not self.fsdp and data_count(self.mesh) > 1:
            average_gradients(self.optimizer, self.mesh.get_group("data"),
                              data_count(self.mesh))
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

    # -- scale-out -------------------------------------------------------------------
    def setup_mesh(self, mesh_config) -> None:
        """TRAINING.MESH {MODEL_PARALLEL, FSDP}: the (data, model) mesh (a
        ``data`` mesh over the group for more than one process without a
        MESH).  One process with no MESH has none."""
        self.mesh, self.wrapper = None, None
        mesh_config = mesh_config or {}
        self.fsdp = bool(mesh_config.get("FSDP"))
        if not mesh_config and process_count() == 1:
            return
        if mesh_config:
            self.mesh = get_mesh_2d(int(mesh_config.get("MODEL_PARALLEL", 1)), self.device)
        else:
            self.mesh = get_mesh(self.device)
        logger.info("Device mesh: %s (fsdp=%s)", dict(zip(self.mesh.mesh_dim_names,
                                                          self.mesh.shape)), self.fsdp)

    @property
    def tensor_parallel(self) -> bool:
        return model_count(self.mesh) > 1

    def setup_parallel(self) -> None:
        """Tensor parallelism over ``model`` first, then the data wrapper:
        FSDP at once (FSDP2's 2-D composition over the tensor-parallel
        DTensors); DDP at the first training forward, which tells it whether
        the loss leaves parameters unread, where there is no model axis (DDP
        takes no DTensor: with one, ``average_gradients`` averages over
        ``data``)."""
        if self.tensor_parallel:
            placed = apply_tensor_parallel(self.model, self.mesh)
            logger.info("Tensor parallelism: %d parameters placed as DTensors on %d model ranks",
                        len(placed), model_count(self.mesh))
        if self.fsdp:
            self.wrapper = wrap_for_training(TrainForward(self.model), self.mesh, fsdp=True)

    def _wrap_ddp(self, fn, args):
        """DDP around the model, with ``find_unused_parameters`` only where one
        probe run of `fn` (the generator's state restored after it) leaves a
        trainable parameter unread on some rank."""
        state = self.generator.get_state()
        reached = reached_parameters(fn(*args))
        self.generator.set_state(state)
        unread = [name for name, p in self.model.named_parameters()
                  if p.requires_grad and id(p) not in reached]
        flag = torch.tensor([float(bool(unread))], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if unread:
            logger.info("DDP: the training loss reads no %s: find_unused_parameters on",
                        unread[:4])
        return wrap_for_training(TrainForward(self.model), self.mesh, fsdp=False,
                                 find_unused=bool(flag.item()))

    def train_forward(self, fn, *args):
        """fn(*args), a training computation of ``self.model`` (a loss), inside
        the DDP or FSDP wrapper's forward when there is one: there DDP sets its
        gradients to be averaged over the data axis, and FSDP gathers the
        weights."""
        if self.mesh is None or (self.tensor_parallel and not self.fsdp):
            return fn(*args)
        if self.wrapper is None:
            self.wrapper = self._wrap_ddp(fn, args)
        return self.wrapper(fn, *args)

    @contextlib.contextmanager
    def eval_weights(self):
        """A context: the whole weights for the eval route, whose decodes and
        kernel bundles read them outside any forward: under FSDP gathered over
        ``data`` (``parallel.mesh.full_weights``), under tensor parallelism
        over ``model`` (``parallel.mesh.whole_parameters``), so that the eval
        computes as one process does; every rank enters together."""
        with contextlib.ExitStack() as stack:
            if self.fsdp:
                stack.enter_context(full_weights(self.wrapper))
            if self.tensor_parallel:
                stack.enter_context(whole_parameters(self.model))
            yield

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
        there.  Counts ``data.batches``, ``data.rows``, ``data.rows_valid``
        and the bytes it sends, ``data.h2d_bytes``."""
        transfer = self.config.TRAINING.get("TRANSFER_DTYPE")
        transfer = getattr(torch, transfer) if transfer else None
        out, sent = {}, 0
        with tracing.span("data.put_batch", batch.batch_id):
            for key, value in batch.arrays().items():
                tensor = torch.from_numpy(np.ascontiguousarray(value))
                cast = transfer is not None and tensor.dtype == torch.float32
                if cast:
                    tensor = tensor.to(transfer)
                sent += tensor.numel() * tensor.element_size()
                tensor = tensor.to(self.device, non_blocking=True)
                out[key] = tensor.float() if cast else tensor
        valid = batch.get("sample_valid")
        tracing.count("data.batches")
        tracing.count("data.rows", batch.batch_size)
        tracing.count("data.rows_valid", batch.batch_size if valid is None else int(valid.sum()))
        tracing.count("data.h2d_bytes", sent)
        return out

    def device_batches(self, dataloader, depth: int = 2) -> Iterator[Tuple[Batch, Dict]]:
        """Yield (host_batch, device_batch), `depth` batches ahead of the
        consumer so host-to-device copies are queued before they are needed.
        The consumer's thread works on each yielded batch's id
        (``tracing.set_batch``) until the next."""
        iterator = iter(dataloader)
        queue: deque = deque()

        def fill() -> None:
            with tracing.span("data.wait") as wait:
                host = next(iterator, None)
                wait.batch = getattr(host, "batch_id", None)
            if host is not None:
                queue.append((host, self.put_batch(host)))

        for _ in range(max(1, depth)):
            fill()
        while queue:
            host, device_batch = queue.popleft()
            fill()
            tracing.set_batch(host.batch_id)
            yield host, device_batch

    def _train_step(self, batch) -> torch.Tensor:
        """One optimizer step on a device batch; returns the loss, left on
        the device."""
        with tracing.span("train.step"):
            with tracing.span("train.forward"):
                self.optimizer.zero_grad(set_to_none=True)
                loss = self.train_forward(self.compute_loss, batch)
            with tracing.span("train.backward"):
                loss.backward()
            with tracing.span("train.optimizer"):
                self.optimizer.step()
                self.scheduler.step()
        return loss.detach()

    @staticmethod
    def eval_key(batch, it: int, i: int) -> str:
        """Global sample key for eval dicts: the question_id when present
        (the same on every process, so gather_eval_dicts merges the batches
        that loader sharding repeats at an uneven tail), else a
        (data shard, iteration, row) triple: the model ranks of one data group
        score the same batches, whose copies land on one key."""
        qids = batch.get("question_id")
        if qids is not None:
            return f"q{qids[i]}"
        return f"h{data_shard()[1]}_{it}_{i}"

    # -- observability ---------------------------------------------------------------
    @property
    def profile_dir(self) -> Optional[str]:
        return self.config.TRAINING.get("PROFILE_DIR")

    def log_metrics(self, payload: Dict[str, Any]) -> None:
        """Append one JSON record to <checkpoint dir>/metrics.jsonl (the
        primary process only: one record per epoch, not one per process)."""
        if not is_primary():
            return
        record = {"epoch": self.epoch, "time": time.time(), **payload}
        with open(os.path.join(self.checkpoint_path, "metrics.jsonl"), "a") as handle:
            handle.write(json.dumps(record, default=str) + "\n")

    def dump_json(self, filename: str, payload: Dict[str, Any]) -> None:
        """A prediction file in the checkpoint directory, written by the
        primary process only."""
        if not is_primary():
            return
        with open(os.path.join(self.checkpoint_path, filename), "w+") as handle:
            json.dump(payload, handle, ensure_ascii=False)

    # -- checkpoints -------------------------------------------------------------------
    def _parameter_names(self):
        return [name for name, _ in self.model.named_parameters()]

    def save_checkpoint(self, extras: Dict[str, Any]) -> None:
        """last_model.pth: model, optimizer and schedule state, the generator's
        state (the dropout stream resumes exactly; under a process group every
        rank's, with the mesh's (data, model) shape) and metadata.  Every
        process calls it; the primary writes the whole state (gathered from
        the shards under FSDP or a model axis)."""
        path = os.path.join(self.checkpoint_path, LAST_NAME)
        host = {
            "scheduler": self.scheduler.state_dict(),
            "generator": self.generator.get_state(),
            "metadata": {"epoch": self.epoch, "step": self.scheduler.last_epoch, **extras},
        }
        if process_count() > 1:
            states = [None] * process_count()
            dist.all_gather_object(states, self.generator.get_state())
            model_ranks = model_count(self.mesh)
            for rank, state in enumerate(states):
                # row-major: rank r is model rank r % mp of data group r // mp
                if not torch.equal(state, states[rank - rank % model_ranks]):
                    raise RuntimeError(
                        f"rank {rank}'s generator left its data group's stream: the model "
                        "ranks of one data group must draw the same dropout masks")
            host["generator_by_rank"] = states
            host["generator_layout"] = (data_count(self.mesh), model_ranks)
        if sharded_backend():
            root = self.wrapper if self.fsdp else TrainForward(self.model)
            save_sharded(path, root, self.optimizer, host)
            return
        if self.fsdp or self.tensor_parallel:
            root = self.wrapper if self.fsdp else TrainForward(self.model)
            model, optimizer = full_state(root, self.optimizer, self._parameter_names())
        else:
            model, optimizer = self.model.state_dict(), self.optimizer.state_dict()
        save_checkpoint(path, {"model": model, "optimizer": optimizer, **host})
        if dist.is_initialized():
            dist.barrier()

    def load_checkpoint(self, fname: str) -> Optional[Dict[str, Any]]:
        """Restore the state save_checkpoint wrote, placed again onto this
        run's layout under FSDP or a model axis (whatever the layout that
        wrote it); its metadata, or None when there is no file.  Each rank
        takes its data group's generator state when the checkpoint was written
        by as many data groups; otherwise data group 0 takes the saved primary
        one and the others keep their fresh folded seeds."""
        payload = load_checkpoint(fname)
        if payload is None:
            return None
        logger.info("Loaded checkpoint from %s", fname)
        if "model" not in payload:  # the sharded backend
            root = self.wrapper if self.fsdp else TrainForward(self.model)
            load_sharded(fname, root, self.optimizer)
        elif self.fsdp or self.tensor_parallel:
            root = self.wrapper if self.fsdp else TrainForward(self.model)
            load_full_state(root, self.optimizer, self._parameter_names(),
                            payload["model"], payload["optimizer"])
        else:
            self.model.load_state_dict(payload["model"])
            self.optimizer.load_state_dict(payload["optimizer"])
        self.scheduler.load_state_dict(payload["scheduler"])
        by_rank = payload.get("generator_by_rank")
        groups, model_ranks = payload.get("generator_layout", (len(by_rank or ()), 1))
        if by_rank is not None and groups == data_count(self.mesh):
            self.generator.set_state(by_rank[data_index(self.mesh) * model_ranks])
        elif data_index(self.mesh) == 0:
            self.generator.set_state(payload["generator"])
        return payload["metadata"]

    def start(self):
        raise NotImplementedError

    def get_predictions(self):
        raise NotImplementedError

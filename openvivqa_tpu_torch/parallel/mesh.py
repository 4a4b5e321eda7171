"""The data mesh and the training wrappers, the port's counterpart of
``openvivqa_tpu/parallel/mesh.py``.

``TRAINING.MESH`` picks the wrapper the training forward goes through:
without ``FSDP``, DDP (parameters replicated, gradients averaged over the
``data`` axis); with ``FSDP``, FSDP2's ``fully_shard`` on every transformer
layer and on the root, so that parameters and Adam moments are stored sharded
over ``data`` (ZeRO-3, as the JAX ``state_partition_spec`` shards big leaves
over ``data``).  Each rank runs its kernels on its own local batch, so no
kernel needs a mesh of its own (the JAX package's ``ops/sharding.py``).
Tensor parallelism (``MODEL_PARALLEL`` > 1) is not ported: ``get_mesh_2d``
refuses it.

The wrappers hold a :class:`TrainForward` around the model, whose forward runs
any computation of that model (a task's loss), so that every training route
(the XE loss and SCST's re-run alike) passes through the wrapper's forward,
where DDP prepares its reducer and FSDP gathers the weights.  Decoding and the eval route's
weight bundles read weights outside ``forward``: under FSDP they run inside
:func:`full_weights`, which gathers every sharded module once and keeps it
whole until the eval ends, so that no kernel ever sees a shard.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Set

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _device_type(device) -> str:
    return torch.device(device).type


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "TRAINING.MESH needs a torch.distributed process group: launch under torchrun "
            "(python -m torch.distributed.run ...) or call parallel.multihost.initialize()"
        )


def get_mesh(device="cuda"):
    """A 1-D ``("data",)`` mesh over every process of the group."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group()
    return init_device_mesh(_device_type(device), (dist.get_world_size(),),
                            mesh_dim_names=(DATA_AXIS,))


def get_mesh_2d(model_parallel: int = 1, device="cuda"):
    """A ``("data", "model")`` mesh; only ``model_parallel`` 1 (pure data
    parallelism) is ported."""
    from torch.distributed.device_mesh import init_device_mesh

    if model_parallel > 1:
        raise NotImplementedError(
            f"TRAINING.MESH.MODEL_PARALLEL={model_parallel}: tensor parallelism is not ported "
            "to PyTorch yet (ROADMAP queue 1, the last port item); set MODEL_PARALLEL to 1 "
            "for data parallelism (with FSDP for sharded storage)"
        )
    _require_group()
    return init_device_mesh(_device_type(device), (dist.get_world_size(), 1),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


class TrainForward(nn.Module):
    """The module a training wrapper holds: ``forward(fn, *args)`` returns
    ``fn(*args)``, a training computation of `model` (which it holds, so that
    the wrapper owns its parameters), run inside the wrapper's forward."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(*args)


def layer_modules(model: nn.Module) -> List[nn.Module]:
    """The model's layers: every element of an ``nn.ModuleList`` that has
    submodules of its own (encoder, decoder and backbone layers; not a list of
    convolutions), outermost lists only."""
    found = []

    def walk(module):
        for child in module.children():
            if isinstance(child, nn.ModuleList):
                for element in child:
                    if next(element.children(), None) is not None:
                        found.append(element)
                    else:
                        walk(element)
            else:
                walk(child)

    walk(model)
    return found


def wrap_for_training(module: nn.Module, mesh, fsdp: bool, find_unused: bool = False):
    """DDP over the mesh's ``data`` group, or with `fsdp` FSDP2 in place:
    ``fully_shard`` on each of ``layer_modules(module)`` and then on `module`
    itself, which it returns.  `find_unused` is DDP's
    ``find_unused_parameters``: a walk of the graph on every step, so set it
    only for a model whose training loss leaves parameters unread."""
    data = mesh[DATA_AXIS]
    if fsdp:
        from torch.distributed.fsdp import fully_shard

        for layer in layer_modules(module):
            fully_shard(layer, mesh=data)
        fully_shard(module, mesh=data)
        return module
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(module, process_group=data.get_group(),
                                   find_unused_parameters=find_unused)


def reached_parameters(outputs) -> Set[int]:
    """ids of the leaf tensors (parameters) that the autograd graph of the
    tensors in `outputs` (a tensor, or a dict, list or tuple of them) reads."""
    roots = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            if x.grad_fn is not None:
                roots.append(x.grad_fn)
        elif isinstance(x, dict):
            for value in x.values():
                collect(value)
        elif isinstance(x, (list, tuple)):
            for value in x:
                collect(value)

    collect(outputs)
    seen, reached = set(), set()
    while roots:
        fn = roots.pop()
        if fn in seen:
            continue
        seen.add(fn)
        variable = getattr(fn, "variable", None)
        if variable is not None:
            reached.add(id(variable))
        roots.extend(nxt for nxt, _ in fn.next_functions if nxt is not None)
    return reached


@contextlib.contextmanager
def full_weights(root: nn.Module) -> Iterator[None]:
    """Inside, every FSDP module under `root` (an FSDP ``TrainForward``) holds its whole
    parameters, gathered once and kept across forwards; on leaving they are
    sharded again and the forwards reshard as before.  Every rank must enter
    together: the gathers are collectives."""
    from torch.distributed.fsdp import FSDPModule

    modules = [m for m in root.modules() if isinstance(m, FSDPModule)]
    with torch.no_grad():
        # FSDP2 takes the first module whose forward runs as its root: run the
        # root's (an empty TrainForward call) before any layer's
        root(lambda: None)
    for module in modules:
        module.set_reshard_after_forward(False, recurse=False)
        module.unshard()
    try:
        yield
    finally:
        for module in modules:
            module.reshard()
            # the root never reshards after its forward (FSDP2's own rule)
            module.set_reshard_after_forward(module is not root, recurse=False)

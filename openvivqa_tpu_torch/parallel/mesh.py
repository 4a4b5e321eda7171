"""The (data, model) mesh, tensor parallelism and the training wrappers, the
port's counterpart of ``openvivqa_tpu/parallel/mesh.py``.

``TRAINING.MESH`` lays the processes out as a ``("data", "model")`` grid,
row-major as the JAX package's ``reshape`` is (:func:`get_mesh_2d`).  Along
``model`` (``MODEL_PARALLEL`` > 1) the placement rule of the JAX package's
``param_partition_spec`` (:func:`param_placement`) picks the 2-D weights whose
output columns are split over the ranks: :func:`apply_tensor_parallel` turns
each into a DTensor, and each chosen ``nn.Linear`` and ``nn.Embedding``
computes its column block and all-gathers the output, as GSPMD does for a
column-parallel dense, so that every activation stays whole.  No kernel sees
a shard: each kernel bundle and each read of a weight outside its module's
forward goes through :func:`whole`, and the eval route swaps whole weights in
for its length (:func:`whole_parameters`), the JAX kernels' replicated
in_specs.  Everything that the JAX package keys by the data shard (the
loader's shard, the loss denominator, the dropout seed, the eval keys) is
keyed by :func:`data_index` / :func:`data_count`, so the model ranks of one
data group read the same batches and draw the same masks.

Along ``data`` the wrapper the training forward goes through is DDP
(parameters replicated, gradients averaged), or with ``FSDP`` FSDP2's
``fully_shard`` on every transformer layer and on the root, so that
parameters and Adam moments are stored sharded over ``data`` (ZeRO-3, as the
JAX ``state_partition_spec`` shards big leaves over ``data``; over the
tensor-parallel DTensors this is FSDP2's 2-D composition).  DDP takes no
DTensor: under a model axis without FSDP the gradients are averaged over
``data`` before each optimizer step instead (:func:`average_gradients`).  Each
rank runs its kernels on its own local batch, so no kernel needs a mesh of its
own (the JAX package's ``ops/sharding.py``).

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
import functools
from typing import Iterator, List, Set, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..logging_utils import setup_logger
from .multihost import process_count, process_index

logger = setup_logger()

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the mesh the process built last (a task's): the loader's shard, the loss
# denominator and the eval keys follow its data axis
_current_mesh = None


def _device_type(device) -> str:
    return torch.device(device).type


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "TRAINING.MESH needs a torch.distributed process group: launch under torchrun "
            "(python -m torch.distributed.run ...) or call parallel.multihost.initialize()"
        )


def _keep(mesh):
    global _current_mesh
    _current_mesh = mesh
    return mesh


def get_mesh(device="cuda"):
    """A 1-D ``("data",)`` mesh over every process of the group."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group()
    return _keep(init_device_mesh(_device_type(device), (dist.get_world_size(),),
                                  mesh_dim_names=(DATA_AXIS,)))


def get_mesh_2d(model_parallel: int = 1, device="cuda"):
    """A ``("data", "model")`` mesh of world // `model_parallel` x
    `model_parallel` processes, row-major: the ranks of one data group are
    consecutive.  A `model_parallel` that does not divide the world raises."""
    from torch.distributed.device_mesh import init_device_mesh

    world = process_count()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} devices not divisible by model_parallel={model_parallel}")
    _require_group()
    device_type = _device_type(device)
    if model_parallel > 1 and device_type != "cpu" and dist.get_backend() == "gloo":
        stage_collectives_through_host(device_type)
    return _keep(init_device_mesh(device_type, (world // model_parallel, model_parallel),
                                  mesh_dim_names=(DATA_AXIS, MODEL_AXIS)))


# DTensor's collectives, by their names in torch.distributed._functional_collectives
# (the names differ between torch releases: each one present is staged)
STAGED_COLLECTIVES = ("all_gather_tensor", "all_gather_single", "all_reduce",
                      "reduce_scatter_tensor", "reduce_scatter_single", "all_to_all_single",
                      "broadcast")
_staged = {}  # name -> the collective it replaced


def _through_host(collective, device_type: str):
    @functools.wraps(collective)
    def staged(tensor, *args, **kwargs):
        if tensor.device.type != device_type:
            return collective(tensor, *args, **kwargs)
        out = collective(tensor.to("cpu", copy=True), *args, **kwargs)
        if hasattr(out, "wait"):  # an AsyncCollectiveTensor
            out = out.wait()
        return out.to(tensor.device)

    return staged


def stage_collectives_through_host(device_type: str) -> List[str]:
    """Route DTensor's collectives (the functional collectives it calls) of
    tensors on `device_type` through host memory: each one runs on a host
    copy and its result is copied back.  Gloo's functional collectives crash
    on CUDA tensors (torch 2.11: a segfault in ``wait_tensor``, seen on an
    H100), while its functional collectives on host tensors and its c10d
    collectives on CUDA tensors work; so a gloo group over CUDA devices (two
    ranks sharing one card) takes this route, and NCCL never does.  Returns
    the names staged; installing twice changes nothing."""
    import torch.distributed._functional_collectives as funcol

    for name in STAGED_COLLECTIVES:
        collective = getattr(funcol, name, None)
        if collective is not None and name not in _staged:
            _staged[name] = collective
            setattr(funcol, name, _through_host(collective, device_type))
    logger.info("DTensor collectives of %s tensors go through host memory: %s", device_type,
                sorted(_staged))
    return sorted(_staged)


def _axis_size(mesh, axis: str) -> int:
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def data_count(mesh) -> int:
    """The size of `mesh`'s ``data`` axis; 1 without a mesh."""
    return _axis_size(mesh, DATA_AXIS)


def data_index(mesh) -> int:
    """This process's coordinate along `mesh`'s ``data`` axis; 0 without a mesh."""
    return 0 if mesh is None else mesh.get_local_rank(DATA_AXIS)


def model_count(mesh) -> int:
    """The size of `mesh`'s ``model`` axis; 1 without one."""
    return _axis_size(mesh, MODEL_AXIS)


def data_shard() -> Tuple[int, int]:
    """(data_count, data_index) of the mesh the process built last, under
    its process group; without one, the process group's (count, rank)."""
    if _current_mesh is not None and dist.is_initialized():
        return data_count(_current_mesh), data_index(_current_mesh)
    return process_count(), process_index()


def data_group():
    """The process group of the last mesh's ``data`` axis, or None (the
    default group) without a mesh."""
    if _current_mesh is None or not dist.is_initialized():
        return None
    return _current_mesh.get_group(DATA_AXIS)


# -- tensor parallelism ------------------------------------------------------------------------
def param_placement(module: nn.Module, name: str, param: torch.Tensor, mp: int):
    """The JAX package's ``param_partition_spec`` for `module`'s parameter
    `name` at `mp` model ranks, restated for torch's layouts: a 2-D weight
    of ``out`` output and ``in`` input features whose ``out`` is a multiple of
    `mp` and at least 2 `mp`, with ``in`` at least 8, is split along ``out``;
    everything else is whole (``Replicate``).  An ``nn.Linear`` weight is
    (out, in): ``Shard(0)``.  An ``nn.Embedding`` weight is (num, dim), flax's
    ``Embed`` layout, and so is every raw 2-D parameter (``models/convert.py``
    copies them as flax holds them): ``Shard(1)``.  An RNN's weights stay
    whole: its cuDNN kernel reads them as one flat buffer, which no DTensor
    can be."""
    if mp <= 1 or param.ndim != 2 or isinstance(module, nn.RNNBase):
        return Replicate()
    if isinstance(module, nn.Linear):
        (out, inp), dim = param.shape, 0
    else:
        (inp, out), dim = param.shape, 1
    if out % mp == 0 and out >= 2 * mp and inp >= 8:
        return Shard(dim)
    return Replicate()


def _replicate_input(module, args):
    if not isinstance(module.weight, DTensor):  # whole weights swapped in
        return None
    return (DTensor.from_local(args[0], module.weight.device_mesh, [Replicate()],
                               run_check=False), *args[1:])


def _gather_output(module, args, out):
    if not isinstance(out, DTensor):
        return None
    return out.redistribute(placements=[Replicate()]).to_local()


def apply_tensor_parallel(model: nn.Module, mesh) -> List[str]:
    """Place every parameter of `model` that :func:`param_placement` splits
    as a DTensor on ``mesh["model"]`` (a chosen ``nn.Linear``'s bias too,
    whole: a DTensor of the ``Replicate`` placement), and make each such
    Linear and Embedding take a whole input and give a whole output (its
    column block all-gathered).  A raw parameter is read through
    :func:`whole`.  Returns the names of the parameters placed."""
    mp = model_count(mesh)
    if mp <= 1:
        return []
    tp_mesh = mesh[MODEL_AXIS]
    coordinate = tp_mesh.get_local_rank()
    placed, done = [], {}  # done: a tied parameter's DTensor, by the id of the tensor it replaced
    for prefix, module in model.named_modules():
        chosen = {}
        for name, param in module.named_parameters(recurse=False):
            placement = param_placement(module, name, param, mp)
            if isinstance(placement, Shard):
                chosen[name] = placement
        if not chosen:
            continue
        if isinstance(module, nn.Linear) and module.bias is not None:
            chosen["bias"] = Replicate()  # whole, as the JAX rule keeps 1-D leaves
        for name, placement in chosen.items():
            param = getattr(module, name)
            if id(param) not in done:
                # every rank holds the whole weight (one seed, or one loaded state):
                # each keeps its block, with no collective
                local = param.detach()
                if isinstance(placement, Shard):
                    local = local.chunk(mp, placement.dim)[coordinate].contiguous()
                done[id(param)] = nn.Parameter(
                    DTensor.from_local(local, tp_mesh, [placement], run_check=False),
                    requires_grad=param.requires_grad)
                placed.append(f"{prefix}.{name}" if prefix else name)
            setattr(module, name, done[id(param)])
        if isinstance(module, (nn.Linear, nn.Embedding)):
            module.register_forward_pre_hook(_replicate_input)
            module.register_forward_hook(_gather_output)
    return placed


def whole(tensor: torch.Tensor) -> torch.Tensor:
    """`tensor` itself, or a DTensor's whole value (an all-gather over its
    mesh, differentiable; every rank of the mesh must call it together)."""
    return tensor.full_tensor() if isinstance(tensor, DTensor) else tensor


@contextlib.contextmanager
def whole_parameters(model: nn.Module) -> Iterator[None]:
    """Inside, every DTensor parameter of `model` is replaced by a plain
    parameter holding its whole value (gathered once), so that the eval
    route computes with whole weights everywhere, as at one model rank; on
    leaving, the DTensors are put back.  Every rank must enter together."""
    swapped, gathered = [], {}
    with torch.no_grad():
        for module in model.modules():
            for name, param in list(module.named_parameters(recurse=False)):
                if isinstance(param, DTensor):
                    if id(param) not in gathered:
                        gathered[id(param)] = nn.Parameter(param.full_tensor(),
                                                           requires_grad=param.requires_grad)
                    swapped.append((module, name, param))
                    setattr(module, name, gathered[id(param)])
    try:
        yield
    finally:
        for module, name, param in swapped:
            setattr(module, name, param)


def average_gradients(optimizer: torch.optim.Optimizer, group, count: int) -> None:
    """Before each step of `optimizer`, average its parameters' gradients
    (a DTensor's local shard) over the process `group` of `count` data
    ranks in one all-reduce, as DDP does where it cannot take DTensors.  A
    parameter without a gradient on some rank counts zero there; one without
    a gradient on every rank keeps none, as DDP's unused parameters do."""
    params = [p for group_ in optimizer.param_groups for p in group_["params"]]

    def average(*_):
        device = params[0].device
        has = torch.tensor([float(p.grad is not None) for p in params], device=device)
        dist.all_reduce(has, op=dist.ReduceOp.MAX, group=group)
        grads = []
        for p, reached in zip(params, has.tolist()):
            if not reached:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad)
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= count
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    optimizer.register_step_pre_hook(average)


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
    only for a model whose training loss leaves parameters unread.  Under a
    model axis FSDP splits a tensor-parallel Linear weight (out, in) along
    ``in`` over ``data`` where ``in`` divides evenly, the JAX package's
    combined (data, model) layout of the flax kernel (in, out)."""
    data = mesh[DATA_AXIS]
    if fsdp:
        from torch.distributed.fsdp import fully_shard

        options = {}
        if model_count(mesh) > 1:
            count = data.size()

            def data_dim(param):
                split_out = param.ndim == 2 and Shard(0) in getattr(param, "placements", ())
                return Shard(1) if split_out and param.shape[1] % count == 0 else Shard(0)

            options["shard_placement_fn"] = data_dim
        for layer in layer_modules(module):
            fully_shard(layer, mesh=data, **options)
        fully_shard(module, mesh=data, **options)
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

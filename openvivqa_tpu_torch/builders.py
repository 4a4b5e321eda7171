"""The port's ARCHITECTURE and TASK registries and their build functions.

The host layers are shared with the JAX package: vocabularies, datasets and
word embeddings register in ``openvivqa_tpu.builders``'s registries when
``openvivqa_tpu.data`` is imported, which imports no JAX.  The port never calls
``openvivqa_tpu.builders.populate()``, which would import the JAX models and
tasks; it keeps its own registries for what it implements in torch.
"""

from __future__ import annotations

from openvivqa_tpu.builders import build_dataset, build_vocab  # noqa: F401 (shared)
from openvivqa_tpu.registry import Registry

META_ARCHITECTURE = Registry("ARCHITECTURE")
META_TASK = Registry("TASK")


def build_model(config, vocab):
    """Instantiate the MODEL node's architecture (on the CPU; callers move it)."""
    name = config.ARCHITECTURE
    # the JAX package's schema dispatch: configs/iterative_m4c.yaml names M4C
    # but carries the IterativeM4C schema
    if name == "M4C" and config.get("OCR_DET_EMBEDDING") is not None:
        name = "IterativeM4C"
    return META_ARCHITECTURE.get(name)(config=config, vocab=vocab)


def build_task(config, device, params=None):
    """Instantiate config.TASK with its model on `device`; `params` is an
    optional flax parameter tree to load instead of a seeded random init."""
    return META_TASK.get(config.TASK)(config, device, params=params)


_POPULATED = False


def populate() -> None:
    """Import the shared data layer and the port's models and tasks so that
    their registrations run."""
    global _POPULATED
    if _POPULATED:
        return
    _POPULATED = True
    import openvivqa_tpu.data  # noqa: F401  (vocabs, datasets, word embeddings)

    from . import models  # noqa: F401
    from . import training  # noqa: F401

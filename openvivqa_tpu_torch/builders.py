"""The port's registries and their build functions.

The port keeps its own copies of the JAX package's host layers (config,
registry, data, evaluation) and imports nothing of ``openvivqa_tpu``; the
VOCAB, DATASET and WORD_EMBEDDING registries fill when ``openvivqa_tpu_torch.data``
is imported, ARCHITECTURE, ENCODER, DECODER, ATTENTION, TEXT_EMBEDDING,
VISION_EMBEDDING and PRETRAINED_LANGUAGE_MODEL when ``openvivqa_tpu_torch.models``
is, TASK when the tasks are.
"""

from __future__ import annotations

from .registry import Registry

META_ARCHITECTURE = Registry("ARCHITECTURE")
META_TASK = Registry("TASK")
META_DATASET = Registry("DATASET")
META_VOCAB = Registry("VOCAB")
META_WORD_EMBEDDING = Registry("WORD_EMBEDDING")
META_ENCODER = Registry("ENCODER")
META_DECODER = Registry("DECODER")
META_ATTENTION = Registry("ATTENTION")
META_TEXT_EMBEDDING = Registry("TEXT_EMBEDDING")
META_VISION_EMBEDDING = Registry("VISION_EMBEDDING")
META_PRETRAINED_LANGUAGE_MODEL = Registry("PRETRAINED_LANGUAGE_MODEL")


def build_model(config, vocab, example=None):
    """Instantiate the MODEL node's architecture (on the CPU; callers move it).
    `example`, one sample's host arrays by field, gives the input widths that
    flax infers from the data: each config node an architecture names in its
    FEATURE_INPUTS, and that the config has, gets D_FEATURE = the summed last
    dims of those fields, or, where FEATURE_INPUTS maps the node to a dict of
    keys to fields, each of those keys."""
    name = config.ARCHITECTURE
    # the JAX package's schema dispatch: configs/iterative_m4c.yaml names M4C
    # but carries the IterativeM4C schema
    if name == "M4C" and config.get("OCR_DET_EMBEDDING") is not None:
        name = "IterativeM4C"
    architecture = META_ARCHITECTURE.get(name)
    inputs = getattr(architecture, "FEATURE_INPUTS", {})
    if example is not None and inputs:
        def width(fields):
            return sum(int(example[field].shape[-1]) for field in fields)

        config = config.merged({
            node: {key: width(fields) for key, fields in (
                keys.items() if isinstance(keys, dict) else (("D_FEATURE", keys),))}
            for node, keys in inputs.items() if config.get(node) is not None
        })
    return architecture(config=config, vocab=vocab)


def build_task(config, device="cuda", params=None):
    """Instantiate config.TASK with its model on `device` (the card unless the
    caller asks for the CPU); `params` is an optional flax parameter tree, as
    numpy arrays, to load instead of a seeded random init."""
    return META_TASK.get(config.TASK)(config, device, params=params)


def build_dataset(json_path, vocab, config):
    if json_path is None:
        return None
    return META_DATASET.get(config.TYPE)(json_path, vocab, config)


def build_vocab(config):
    return META_VOCAB.get(config.TYPE)(config)


def build_encoder(config):
    return META_ENCODER.get(config.ARCHITECTURE)(config=config)


def build_decoder(config, vocab):
    return META_DECODER.get(config.ARCHITECTURE)(config=config, vocab=vocab)


def build_attention(config):
    return META_ATTENTION.get(config.ARCHITECTURE)(config=config)


def build_text_embedding(config, vocab):
    return META_TEXT_EMBEDDING.get(config.ARCHITECTURE)(config=config, vocab=vocab)


def build_vision_embedding(config):
    return META_VISION_EMBEDDING.get(config.ARCHITECTURE)(config=config)


def build_pretrained_language_model(config, vocab=None):
    return META_PRETRAINED_LANGUAGE_MODEL.get(config.ARCHITECTURE)(config=config, vocab=vocab)


def build_word_embedding(config):
    """One embedding or a list of names whose vectors the vocab concatenates."""
    names = config.WORD_EMBEDDING
    cache = config.get("WORD_EMBEDDING_CACHE")
    if isinstance(names, (list, tuple)):
        return [META_WORD_EMBEDDING.get(n)(cache) for n in names]
    return META_WORD_EMBEDDING.get(names)(cache)


_POPULATED = False


def populate() -> None:
    """Import the port's data layer, models and tasks so that their
    registrations run."""
    global _POPULATED
    if _POPULATED:
        return
    _POPULATED = True
    from . import data  # noqa: F401  (vocabs, datasets, word embeddings)
    from . import models  # noqa: F401
    from . import training  # noqa: F401

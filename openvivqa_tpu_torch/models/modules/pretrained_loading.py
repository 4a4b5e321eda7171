"""The pretrained-weights policy: local backbone weights into the model, or a
refusal.

Counterpart of ``openvivqa_tpu/models/modules/pretrained_loading.py``, on local
files only.  A config node that names pretrained weights (a wrapper node with
PRETRAINED_NAME or CONVERTED_WEIGHTS, ``LOAD_PRETRAINED: false`` opting it
out; a TEXT_BERT node with LOAD_PRETRAINED true) must resolve them:

* ``CONVERTED_WEIGHTS``: a converted flax file, as ``scripts/convert_backbone.py``
  writes it, ``.npz`` ('/'-joined flax keys, read with numpy) or ``.msgpack``
  (flax's serialization, decoded here: nested maps, ndarrays in msgpack ext
  type 1 as (shape, dtype, bytes)); its flax tree is mapped to the port's names
  through ``models/convert.py``;
* else PRETRAINED_NAME as a local Hugging Face checkpoint: a directory, or a
  snapshot in the hub cache (``models--org--name/snapshots/<rev>/``), its
  ``config.json`` and ``model.safetensors`` (read by its JSON header) or
  ``pytorch_model.bin`` (``torch.load(weights_only=True)``), without
  ``transformers``; the head prefix (``bert.``, ``roberta.``, ``albert.``,
  ``deberta.``, ``vit.``) is stripped and the first NUM_HIDDEN_LAYERS layers
  are kept, as the JAX package's ``convert_hf_checkpoint`` keeps them.

When nothing resolves, building the task raises ``FileNotFoundError`` unless
``OPENVIVQA_ALLOW_RANDOM_BACKBONE=1``: a config naming a checkpoint that trains
on a random frozen backbone is another model.

Sites are found structurally among the model's modules: a BERT-layout backbone
(``BertBackbone``: the BERT wrappers' and the frozen language models'; the M4C
family's ``TextBert``), a T5, ALBERT or DeBERTa stack, a ViT backbone that the
data feeds pixels.  A requirement takes the first unused site of its family,
the one of its hidden width where several are left (the JAX package's rule).
Tables that differ from the site's in rows only (vocab, positions) are
zero-padded or cut; any other mismatch raises.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...logging_utils import setup_logger

logger = setup_logger()

_ALLOW_ENV = "OPENVIVQA_ALLOW_RANDOM_BACKBONE"

# wrapper architecture name -> weight-layout family
WRAPPER_FAMILIES = {
    "BertEmbedding": "bert",
    "RobertaEmbedding": "roberta",
    "XLMRobertaEmbedding": "roberta",
    "T5Embedding": "t5",
    "AlbertEmbedding": "albert",
    "DebertaEmbedding": "deberta",
    "ViTEmbedding": "vit",
    "BERTModel": "bert",
    "PhoBERTModel": "roberta",
}

# site family -> the requirement families that may seed it
_SITE_ACCEPTS = {
    "bert_layout": ("bert", "roberta"),
    "t5": ("t5",),
    "albert": ("albert",),
    "deberta": ("deberta",),
    "vit": ("vit",),
}

# a checkpoint's head prefix per family (the task model wraps the base model)
_HF_PREFIX = {"bert": "bert.", "roberta": "roberta.", "albert": "albert.",
              "deberta": "deberta.", "vit": "vit.", "t5": ""}
# the kept keys of each family's base model, and its layer-indexed ones
_HF_KEEP = {
    "bert": ("embeddings.", "encoder."), "roberta": ("embeddings.", "encoder."),
    "albert": ("embeddings.", "encoder."), "deberta": ("embeddings.", "encoder."),
    "vit": ("embeddings.", "encoder.", "layernorm."), "t5": ("shared.", "encoder."),
}
_HF_LAYER = re.compile(r"^encoder\.(?:layer|block)\.(\d+)\.")


class Requirement:
    def __init__(self, path: Tuple[str, ...], arch: str, family: str, node):
        self.path = path
        self.arch = arch
        self.family = family
        self.node = node
        self.name = node.get("PRETRAINED_NAME")
        self.converted = node.get("CONVERTED_WEIGHTS")

    @property
    def hidden(self) -> Optional[int]:
        for key in ("D_PRETRAINED_FEATURE", "HIDDEN_SIZE"):
            value = self.node.get(key)
            if value is not None:
                return int(value)
        return None

    def __repr__(self):
        return f"{'.'.join(self.path) or 'MODEL'}:{self.arch}({self.name})"


def _is_mapping(obj) -> bool:
    return hasattr(obj, "keys") and hasattr(obj, "__getitem__")


def collect_pretrained_requirements(model_config) -> List[Requirement]:
    """The MODEL config's nodes that name pretrained weights: a wrapper node
    (ARCHITECTURE in WRAPPER_FAMILIES) with PRETRAINED_NAME or
    CONVERTED_WEIGHTS and no ``LOAD_PRETRAINED: false``, or a TEXT_BERT node
    with LOAD_PRETRAINED true and a name."""
    out: List[Requirement] = []

    def walk(node, path):
        if not _is_mapping(node):
            return
        arch = node.get("ARCHITECTURE")
        load_flag = node.get("LOAD_PRETRAINED")
        named = node.get("PRETRAINED_NAME") or node.get("CONVERTED_WEIGHTS")
        if arch in WRAPPER_FAMILIES and named and load_flag is not False:
            out.append(Requirement(path, arch, WRAPPER_FAMILIES[arch], node))
        elif path and path[-1] == "TEXT_BERT" and load_flag and named:
            name = str(node.get("PRETRAINED_NAME") or "").lower()
            family = "roberta" if ("roberta" in name or "phobert" in name) else "bert"
            out.append(Requirement(path, "TextBert", family, node))
        for key in node.keys():
            value = node.get(key)
            if _is_mapping(value):
                walk(value, path + (str(key),))

    walk(model_config, ())
    return out


# ---------------------------------------------------------------------------
# sites
# ---------------------------------------------------------------------------
class Site:
    """A module the policy loads: its family, hidden width and depth."""

    def __init__(self, path: str, family: str, module: nn.Module):
        self.path = path
        self.family = family
        self.module = module

    @property
    def hidden(self) -> int:
        m = self.module
        if self.family == "t5":
            return m.shared.embedding_dim
        if self.family == "albert":
            return m.encoder.embedding_hidden_mapping_in.out_features
        if self.family == "vit":
            return int(m.embeddings.cls_token.shape[-1])
        return m.embeddings.word_embeddings.embedding_dim

    @property
    def layers(self) -> int:
        m = self.module
        if self.family == "t5":
            return len(m.encoder.block)
        if self.family == "albert":
            return m.num_layers
        return len(m.encoder.layer)


def find_wrapper_sites(model: nn.Module, example=None) -> List[Site]:
    """The model's pretrained sites in module order.  A ViT backbone counts
    only when the data feeds it pixels (`example`, one sample's fields, has
    ``pixel_values``), as the JAX package's ViTEmbedding has no backbone
    parameters on pre-extracted features."""
    from ..m4c_common import TextBert
    from .albert import AlbertEncoderStack
    from .deberta import DebertaV2EncoderStack
    from .pretrained_embeddings import BertBackbone
    from .t5 import T5EncoderStack
    from .vit import ViTBackbone

    kinds = ((TextBert, "bert_layout"), (BertBackbone, "bert_layout"), (T5EncoderStack, "t5"),
             (AlbertEncoderStack, "albert"), (DebertaV2EncoderStack, "deberta"),
             (ViTBackbone, "vit"))
    pixels = example is None or "pixel_values" in example
    sites: List[Site] = []
    for name, module in model.named_modules():
        if any(name.startswith(site.path + ".") for site in sites if site.path):
            continue
        family = next((fam for cls, fam in kinds if type(module) is cls), None)
        if family is not None and (family != "vit" or pixels):
            sites.append(Site(name, family, module))
    return sites


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------
def _hub_caches() -> List[str]:
    caches = []
    if os.environ.get("HF_HUB_CACHE"):
        caches.append(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        caches.append(os.path.join(os.environ["HF_HOME"], "hub"))
    xdg = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    caches.append(os.path.join(xdg, "huggingface", "hub"))
    return caches


def local_hf_dir(name: str) -> Optional[str]:
    """The local directory of the checkpoint `name`: the directory itself, or
    its snapshot in a hub cache (the revision refs/main names, else any
    snapshot with a config.json); None when there is none."""
    if os.path.isfile(os.path.join(name, "config.json")):
        return name
    for cache in _hub_caches():
        repo = os.path.join(cache, "models--" + name.replace("/", "--"))
        snapshots = os.path.join(repo, "snapshots")
        if not os.path.isdir(snapshots):
            continue
        revisions = sorted(os.listdir(snapshots))
        ref = os.path.join(repo, "refs", "main")
        if os.path.isfile(ref):
            with open(ref) as handle:
                revisions.insert(0, handle.read().strip())
        for rev in revisions:
            path = os.path.join(snapshots, rev)
            if os.path.isfile(os.path.join(path, "config.json")):
                return path
    return None


def resolve_source(req: Requirement):
    """-> ("converted", path) | ("hf_local", directory) | None."""
    if req.converted:
        if os.path.exists(str(req.converted)):
            return ("converted", str(req.converted))
        raise FileNotFoundError(f"{req!r}: CONVERTED_WEIGHTS={req.converted!r} does not exist")
    if req.name:
        path = local_hf_dir(str(req.name))
        if path is not None:
            return ("hf_local", path)
    return None


# -- converted flax files ------------------------------------------------------------
def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _bfloat16_to_float32(raw: bytes) -> np.ndarray:
    return (np.frombuffer(raw, np.uint16).astype(np.uint32) << 16).view(np.float32)


def _ndarray(shape, dtype_name, raw: bytes) -> np.ndarray:
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        return _bfloat16_to_float32(raw).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy()


class _MsgpackReader:
    """The subset of msgpack flax writes: nil, bools, ints, floats, str, bin,
    arrays, maps, and ext types 1 (an ndarray) and 3 (a numpy scalar), each
    the msgpack of (shape, dtype name, bytes)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> bytes:
        out = self.data[self.pos: self.pos + n]
        if len(out) != n:
            raise ValueError("msgpack: truncated input")
        self.pos += n
        return bytes(out)

    def _unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self._take(struct.calcsize(">" + fmt)))[0]

    def _ext(self, code: int, payload: bytes):
        if code in (1, 3):  # an ndarray, a numpy scalar: both (shape, dtype, bytes)
            return _ndarray(*_MsgpackReader(payload).read())
        raise ValueError(f"msgpack: ext type {code} is not a flax ndarray")

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode()
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sizes = {0xC4: "B", 0xC5: "H", 0xC6: "I", 0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if b in sizes:
            raw = self._take(self._unpack(sizes[b]))
            return raw.decode() if b >= 0xD9 else raw
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack({0xC7: "B", 0xC8: "H", 0xC9: "I"}[b])
            code = self._unpack("b")
            return self._ext(code, self._take(n))
        if 0xD4 <= b <= 0xD8:
            code = self._unpack("b")
            return self._ext(code, self._take(1 << (b - 0xD4)))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self._unpack(numbers[b])
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self._unpack("H" if b == 0xDC else "I"))]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack("H" if b == 0xDE else "I"))
        raise ValueError(f"msgpack: unknown type byte {b:#x}")

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key.decode() if isinstance(key, bytes) else key] = self.read()
        return out


def msgpack_restore(data: bytes) -> Dict:
    """A flax ``serialization.msgpack_serialize`` payload -> its nested dict of
    numpy arrays."""
    reader = _MsgpackReader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the first object")
    return tree


def load_converted_file(path: str) -> Dict:
    """A converted flax tree: ``.npz`` with '/'-joined keys, else flax msgpack."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as data:
            return _unflatten({key: data[key] for key in data.files})
    with open(path, "rb") as handle:
        return msgpack_restore(handle.read())


# -- local Hugging Face checkpoints ---------------------------------------------------
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file by its header: an 8-byte little-endian length,
    a JSON map of name -> dtype, shape and data offsets, then the data."""
    with open(path, "rb") as handle:
        (n,) = struct.unpack("<Q", handle.read(8))
        header = json.loads(handle.read(n))
        data = bytearray(handle.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        flat = torch.frombuffer(data, dtype=torch.uint8, count=end - begin, offset=begin) \
            if end > begin else torch.empty(0, dtype=torch.uint8)
        out[name] = flat.view(dtype).reshape(info["shape"]).clone()
    return out


def read_hf_checkpoint(directory: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(state dict, config.json) of a local checkpoint directory: its
    ``model.safetensors``, else its ``pytorch_model.bin``."""
    with open(os.path.join(directory, "config.json")) as handle:
        config = json.load(handle)
    path = os.path.join(directory, "model.safetensors")
    if os.path.isfile(path):
        return read_safetensors(path), config
    path = os.path.join(directory, "pytorch_model.bin")
    if os.path.isfile(path):
        return torch.load(path, map_location="cpu", weights_only=True), config
    raise FileNotFoundError(f"{directory}: no model.safetensors or pytorch_model.bin")


def hf_site_state(family: str, state: Dict[str, torch.Tensor], hf_config: Dict[str, Any],
                  site_layers: int) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict -> the site's names: the head prefix
    stripped, the base model's keys kept, the first min(site_layers, the
    checkpoint's) layers kept (every ALBERT group: its layers are shared),
    RoBERTa's positions re-based past its padding offset of 2 and its one
    token-type row repeated to the site's two."""
    prefix = _HF_PREFIX[family]
    depth = min(site_layers, int(hf_config.get("num_hidden_layers")
                                 or hf_config.get("num_layers") or site_layers))
    out = {}
    for key, value in state.items():
        if prefix and key.startswith(prefix):
            key = key[len(prefix):]
        if not key.startswith(_HF_KEEP[family]) or key.endswith("position_ids"):
            continue
        layer = _HF_LAYER.match(key)
        if family != "albert" and layer and int(layer.group(1)) >= depth:
            continue
        out[key] = value
    if family == "roberta":
        out["embeddings.position_embeddings.weight"] = \
            out["embeddings.position_embeddings.weight"][2:]
        types = out["embeddings.token_type_embeddings.weight"]
        out["embeddings.token_type_embeddings.weight"] = types[:1].expand(2, -1)
    if family == "t5" and "encoder.embed_tokens.weight" not in out:
        out["encoder.embed_tokens.weight"] = out["shared.weight"]
    return out


# ---------------------------------------------------------------------------
# loading into a site
# ---------------------------------------------------------------------------
def load_into_site(module: nn.Module, state: Dict[str, Any], where: str = "") -> None:
    """Copy `state` (numpy arrays or tensors) into `module`'s parameters.  An
    embedding table that differs from the site's in rows only is zero-padded or
    cut; a key the site lacks, any other shape mismatch, or a site key that
    `state` lacks raises, except the layers past the checkpoint's depth, which
    keep their values."""
    target = module.state_dict()
    depth = 1 + max((int(m.group(1)) for m in map(_HF_LAYER.match, state) if m), default=-1)
    missing = [key for key in target if key not in state
               and not ((m := _HF_LAYER.match(key)) and int(m.group(1)) >= depth)]
    if missing:
        raise KeyError(f"{where}: the weights lack {len(missing)} of the site's keys, "
                       f"e.g. {missing[:3]}")
    embeddings = {f"{name}.weight" for name, sub in module.named_modules(remove_duplicate=False)
                  if isinstance(sub, nn.Embedding)}
    loaded = {}
    for key, value in state.items():
        if key not in target:
            raise KeyError(f"{where}: converted weight {key} has no slot in the site")
        have = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value) else value)
        have = have.to(target[key].dtype)
        want = target[key].shape
        if have.shape != want:
            if key in embeddings and have.ndim == 2 and have.shape[1:] == want[1:]:
                rows = want[0]
                have = have[:rows] if have.shape[0] >= rows else torch.cat(
                    [have, have.new_zeros((rows - have.shape[0],) + tuple(want[1:]))])
                logger.info("resized %s.%s rows to %d", where, key, rows)
            else:
                raise ValueError(f"shape mismatch at {where}.{key}: converted "
                                 f"{tuple(have.shape)} vs site {tuple(want)}")
        loaded[key] = have
    with torch.no_grad():
        for key, value in loaded.items():
            target[key].copy_(value)


def _site_state(kind: str, ref: str, req: Requirement, site: Site) -> Dict[str, Any]:
    from ..convert import backbone_state

    if kind == "hf_local":
        state, hf_config = read_hf_checkpoint(ref)
        return hf_site_state(req.family, state, hf_config, site.layers)
    tree = load_converted_file(ref)
    # converted files may carry the whole wrapper or the backbone
    if site.family not in ("bert_layout", "vit") and "backbone" in tree:
        tree = tree["backbone"]
    return backbone_state(site.family, tree)


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------
def apply_pretrained_policy(model_config, model: nn.Module,
                            example=None) -> List[Tuple[Requirement, str]]:
    """Load every requirement of `model_config` into its site of `model` from
    local weights, in place; raise FileNotFoundError for one that does not
    resolve unless OPENVIVQA_ALLOW_RANDOM_BACKBONE is set.  Returns each
    requirement's outcome: "no-site", "random" or "<kind>:<path>"."""
    reqs = collect_pretrained_requirements(model_config)
    if not reqs:
        return []
    sites = find_wrapper_sites(model, example)
    allow = os.environ.get(_ALLOW_ENV, "").lower() in ("1", "on", "true")
    report = []
    used = set()
    for req in reqs:
        candidates = [s for s in sites
                      if s.path not in used and req.family in _SITE_ACCEPTS[s.family]]
        if len(candidates) > 1 and req.hidden:
            candidates = [s for s in candidates if s.hidden == req.hidden] or candidates
        if not candidates:
            report.append((req, "no-site"))
            continue
        site = candidates[0]
        used.add(site.path)
        source = resolve_source(req)
        if source is None:
            message = (
                f"{req!r} names pretrained weights but nothing resolves locally (no "
                f"CONVERTED_WEIGHTS, '{req.name}' is no local checkpoint directory and not "
                "in the Hugging Face hub cache).  Convert the checkpoint with "
                "scripts/convert_backbone.py and set CONVERTED_WEIGHTS, or set "
                f"{_ALLOW_ENV}=1 to train with a RANDOM frozen backbone (another model)."
            )
            if not allow:
                raise FileNotFoundError(message)
            logger.warning("%s: proceeding with random weights", message)
            report.append((req, "random"))
            continue
        kind, ref = source
        try:
            state = _site_state(kind, ref, req, site)
            load_into_site(site.module, state, site.path or "model")
        except (KeyError, ValueError) as exc:
            raise ValueError(f"{req!r}: the weights from {ref!r} do not fit the site "
                             f"{site.path or 'model'}: {exc}") from exc
        logger.info("seeded %r from %s:%s", req, kind, ref)
        report.append((req, f"{kind}:{ref}"))
    return report

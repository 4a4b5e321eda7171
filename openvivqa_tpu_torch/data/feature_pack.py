"""Packed feature store: one mmap'd blob instead of per-image pickled .npy.

The port's copy of ``openvivqa_tpu/data/feature_pack.py``.  `pack_features`
converts a feature directory once into a contiguous binary pack;
`PackedFeatureStore` serves per-image dicts from an mmap with zero-copy views.

Pack layout (little endian):
  b"OVQAPACK" | u64 header_len | header json (space-padded so the payload
  starts 8-byte aligned — unaligned f32 views hit numpy slow paths) |
  payload (f32 blocks)
header: {"keys": [k...], "shapes": {key: [n, d]}, "images": {id: payload_row},
         "row_bytes": int}   — each image's payload is the concatenation of
its keys' (n, d) float32 blocks in `keys` order, all images same shape.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

MAGIC = b"OVQAPACK"


def pack_features(
    feature_dir: str,
    out_path: str,
    keys: Optional[Sequence[str]] = None,
    pad_rows: Optional[Dict[str, int]] = None,
) -> Dict:
    """Convert a directory of {image_id}.npy dicts into one pack file."""
    files = sorted(
        f for f in os.listdir(feature_dir) if f.endswith(".npy")
    )
    if not files:
        raise FileNotFoundError(f"no .npy feature files in {feature_dir}")

    first = np.load(os.path.join(feature_dir, files[0]), allow_pickle=True)[()]
    if keys is None:
        keys = [
            k
            for k, v in first.items()
            if isinstance(v, np.ndarray)
            and v.dtype != object
            and v.ndim in (1, 2)  # the (n, d) block layout below
        ]
    pad_rows = dict(pad_rows or {})

    def as_block(raw: dict, key: str, fname: str) -> np.ndarray:
        value = np.asarray(raw[key], np.float32)
        if value.ndim == 1:
            value = value[:, None]
        if value.ndim != 2:
            raise ValueError(
                f"{fname}: key '{key}' has ndim {value.ndim}; the pack "
                "stores (n, d) float32 blocks — flatten trailing dims first"
            )
        return value

    shapes = {}
    for key in keys:
        value = as_block(first, key, files[0])
        rows = pad_rows.get(key, value.shape[0])
        shapes[key] = [int(rows), int(value.shape[1])]

    row_bytes = sum(n * d * 4 for n, d in shapes.values())
    # image ids and row indices are fully known up front, so the header is
    # written FIRST and every row streamed behind it — a real feature dir
    # (tens of GB) never has to fit in memory
    images = {os.path.splitext(f)[0]: row for row, f in enumerate(files)}
    header = json.dumps(
        {
            "keys": list(keys),
            "shapes": shapes,
            "images": images,
            "row_bytes": row_bytes,
        }
    ).encode()
    # pad to an 8-byte boundary (JSON ignores trailing spaces): every
    # float32 frombuffer view downstream stays aligned for free
    header += b" " * (-(8 + 8 + len(header)) % 8)

    with open(out_path, "wb") as out:
        out.write(MAGIC)
        out.write(struct.pack("<Q", len(header)))
        out.write(header)
        for fname in files:
            raw = np.load(
                os.path.join(feature_dir, fname), allow_pickle=True
            )[()]
            for key in keys:
                value = as_block(raw, key, fname)
                n, d = shapes[key]
                if value.shape[1] != d:
                    raise ValueError(
                        f"{fname}: key '{key}' is {value.shape[1]} wide but "
                        f"the pack (from {files[0]}) is {d} — refusing to "
                        "silently truncate/zero-pad columns"
                    )
                block = np.zeros((n, d), np.float32)
                usable = min(n, value.shape[0])  # row padding is by design
                block[:usable] = value[:usable]
                out.write(block.astype("<f4").tobytes())
    return {"keys": list(keys), "shapes": shapes, "n_images": len(images)}


class PackedFeatureStore:
    """Per-image feature dicts from a pack file (zero-copy mmap views)."""

    def __init__(self, pack_path: str):
        with open(pack_path, "rb") as handle:
            magic = handle.read(8)
            if magic != MAGIC:
                raise ValueError(f"{pack_path} is not a feature pack")
            (header_len,) = struct.unpack("<Q", handle.read(8))
            header = json.loads(handle.read(header_len))
        self.keys: List[str] = header["keys"]
        self.shapes = {k: tuple(v) for k, v in header["shapes"].items()}
        self.images: Dict[str, int] = header["images"]
        self.row_bytes: int = header["row_bytes"]
        self.payload_offset = 8 + 8 + header_len
        self._offsets = {}
        offset = 0
        for key in self.keys:
            n, d = self.shapes[key]
            self._offsets[key] = offset
            offset += n * d * 4

        self._mmap = np.memmap(pack_path, dtype=np.uint8, mode="r")

    def __contains__(self, image_id) -> bool:
        return str(image_id) in self.images

    def _row_offset(self, image_id) -> int:
        return self.payload_offset + self.images[str(image_id)] * self.row_bytes

    def get(self, image_id) -> Dict[str, np.ndarray]:
        base = self._row_offset(image_id)
        out = {}
        for key in self.keys:
            n, d = self.shapes[key]
            start = base + self._offsets[key]
            view = self._mmap[start : start + n * d * 4]
            array = np.frombuffer(view, dtype="<f4").reshape(n, d)
            out[key] = array.squeeze(-1) if d == 1 else array
        return out

    def gather(self, image_ids: Sequence, key: str) -> np.ndarray:
        """Batched gather of one key for many images -> (len(ids), n, d):
        slices the mmap at each row's key offset directly (building the
        full per-image dict per id constructed k-1 wasted views)."""
        n, d = self.shapes[key]
        key_offset = self._offsets[key]
        size = n * d * 4
        out = np.empty((len(image_ids), n, d), np.float32)
        for i, image_id in enumerate(image_ids):
            start = self._row_offset(image_id) + key_offset
            out[i] = np.frombuffer(
                self._mmap[start : start + size], dtype="<f4"
            ).reshape(n, d)
        return out

    def close(self):
        pass  # mmap closes with the object; kept for API compatibility

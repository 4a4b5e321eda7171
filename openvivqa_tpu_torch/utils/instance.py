"""Host-side sample and batch containers.

The port's copy of ``openvivqa_tpu/utils/instance.py``:

* numeric fields are padded to **static** per-field lengths (dataset-level
  maxima, declared once), so every batch of a split has one shape;
* string / python fields stay host-side as plain lists and never cross the
  device boundary;
* a `sample_valid` mask marks batch-dim padding (the last partial batch is
  padded up to the full batch size).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np


class Instance(dict):
    """Per-sample record with attribute access (utils/instance.py:9-29 parity)."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(f"{key} not found") from None

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def get_fields(self) -> List[str]:
        return list(self.keys())


class Batch(dict):
    """A collated batch: array fields (np/jnp) + host-only list fields.

    Array fields are exposed by attribute exactly like the reference's
    InstanceList, so model code reads `batch.question_tokens` etc.
    ``batch_id``, the loader's sequence number of the batch, is an attribute
    and not a field: no host or device field list holds it.
    """

    batch_id: Optional[int] = None

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(f"{key} not found") from None

    def __setattr__(self, key: str, value: Any) -> None:
        if key == "batch_id":
            object.__setattr__(self, key, value)
        else:
            self[key] = value

    @property
    def batch_size(self) -> int:
        """Padded batch size (the arrays' leading dim).  Defined from
        sample_valid when present — host list fields keep the REAL sample
        count, so a field-order scan would be inconsistent after batch-dim
        padding.  Count real rows via sample_valid.sum()."""
        valid = self.get("sample_valid")
        if valid is not None:
            return int(valid.shape[0])
        for value in self.values():
            if hasattr(value, "shape") and getattr(value, "ndim", 0) >= 1:
                return int(value.shape[0])
            if isinstance(value, list):
                return len(value)
        return 0

    def arrays(self) -> Dict[str, Any]:
        """The device-bound sub-dict (everything with a dtype)."""
        return {k: v for k, v in self.items() if hasattr(v, "dtype")}

    def host_fields(self) -> Dict[str, Any]:
        return {k: v for k, v in self.items() if not hasattr(v, "dtype")}


def _pad_first_dim(array: np.ndarray, target: int, fill: float) -> np.ndarray:
    if array.shape[0] == target:
        return array
    if array.shape[0] > target:
        # a declared static length smaller than a real sample is a
        # misconfiguration (e.g. one split's maxima applied to another);
        # silently dropping tokens would degrade eval undetectably
        raise ValueError(
            f"sample first dim {array.shape[0]} exceeds the declared static "
            f"pad length {target}; fix the pad_to entry"
        )
    pad_widths = [(0, target - array.shape[0])] + [(0, 0)] * (array.ndim - 1)
    return np.pad(array, pad_widths, mode="constant", constant_values=fill)


def collate(
    samples: Sequence[Instance],
    pad_to: Optional[Mapping[str, int]] = None,
    pad_values: Optional[Mapping[str, float]] = None,
    batch_pad_to: Optional[int] = None,
    empty: Optional[Callable[[str, tuple, np.dtype], np.ndarray]] = None,
) -> Batch:
    """Stack a list of Instances into a Batch with static shapes.

    Args:
      samples: the per-sample records.
      pad_to: field -> static first-dim length.  Fields not listed are padded
        to the batch max (still fine when the source data is fixed-size).
      pad_values: field -> fill value (default 0, matching the reference's
        `pad_values` zero fill, instance.py:155-170).
      batch_pad_to: pad the batch dimension up to this size; padded rows are
        marked invalid in the emitted `sample_valid` mask (and repeat the
        last real row).
      empty: (field, shape, dtype) -> the uninitialised array an array field
        is stacked into (default `np.empty`); the loader's workers lay large
        fields out in shared memory through it.
    """
    if not samples:
        return Batch()
    pad_to = pad_to or {}
    pad_values = pad_values or {}

    n_real = len(samples)
    total = batch_pad_to if (batch_pad_to and batch_pad_to > n_real) else n_real
    batch = Batch()
    for key in samples[0].get_fields():
        values = [sample[key] for sample in samples]
        first = values[0]
        if isinstance(first, np.ndarray) and first.dtype != object:
            if first.ndim > 0:
                fill = pad_values.get(key, 0)
                target = pad_to.get(key, max(v.shape[0] for v in values))
                values = [_pad_first_dim(v, target, fill) for v in values]
            dtype = np.result_type(*{v.dtype for v in values})
            shape = (total,) + values[0].shape
            stacked = empty(key, shape, dtype) if empty else np.empty(shape, dtype)
            np.stack(values, axis=0, out=stacked[:n_real])
            stacked[n_real:] = stacked[n_real - 1]
            batch[key] = stacked
        elif isinstance(first, (int, float, bool, np.integer, np.floating)):
            stacked = np.asarray(values)
            if batch_pad_to is not None and batch_pad_to > n_real:
                stacked = np.concatenate(
                    [stacked, np.tile(stacked[-1:], batch_pad_to - n_real)]
                )
            batch[key] = stacked
        else:
            # strings, token lists, answer lists: host-side only
            batch[key] = list(values)

    valid = np.zeros((total,), dtype=np.bool_)
    valid[:n_real] = True
    batch["sample_valid"] = valid
    return batch

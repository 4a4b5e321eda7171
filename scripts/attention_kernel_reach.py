#!/usr/bin/env python3
"""Where the JAX package's streamed and flat attention kernels engage.

    python scripts/attention_kernel_reach.py

Evaluates the package's own dispatch rules (``ops/fused_attention.py``:
``packed_attention_viable``, ``streamed_attention_viable``,
``flat_attention_viable``, the 192-key crossover of ``fused_attention_wins``;
``ops/decode_step.py``: ``decoder_layer_step_viable``) on shapes only, with no
model and no device:

  * the streamed kernel (``fused_attention_packed_streamed``) runs only where
    the packed kernel's VMEM plan fails: the first square sequence length at
    which that happens, per model width;
  * the flat kernel (``fused_attention``) runs from
    ``ScaledDotProductAttention.attend`` with at least 192 keys: every config's
    biases are head-shared and its d_k equals d_v, so the packed route takes
    full-sequence attention, and ``attend`` is reached by a decoder's cross
    step when the decoder-layer kernel has no VMEM plan.  The rows, answer
    lengths and encoder keys of ``configs/joint_transformer_vlsp.yaml``'s beam
    eval (the longest encoder stream among the configs: 100 regions + 100
    region boxes + 49 grids + 49 grid boxes + the question) are checked.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from openvivqa_tpu.ops.decode_step import decoder_layer_step_viable  # noqa: E402
from openvivqa_tpu.ops.fused_attention import (  # noqa: E402
    _MIN_WINNING_KEYS,
    flat_attention_viable,
    packed_attention_viable,
    streamed_attention_viable,
)


def main() -> None:
    for hd, heads in ((512, 8), (768, 12), (1024, 16)):
        packed = max(s for s in range(1, 4096) if packed_attention_viable(s, s, hd, heads))
        streamed = next(s for s in range(packed + 1, 8192)
                        if streamed_attention_viable(s, s, hd, heads))
        print(f"hd {hd}, {heads} heads: packed kernel up to {packed} keys (square); "
              f"streamed kernel from {streamed} keys")
    flat = max(s for s in range(1, 4096) if flat_attention_viable(1, s, 64))
    print(f"flat kernel, one query, d 64: {_MIN_WINNING_KEYS} to {flat} keys")

    # configs/joint_transformer_vlsp.yaml: DICT_DATASET.BATCH_SIZE 60 // beam 3 x 3
    rows, hd, d_ff = 60, 512, 2048
    for question in (10, 30):
        keys = 100 + 100 + 49 + 49 + question
        for answer in (5, 20, 60):
            plan = decoder_layer_step_viable(rows, answer, keys, hd, d_ff)
            print(f"JointTransformer beam eval, {rows} rows, {keys} encoder keys, T {answer}: "
                  f"decoder-layer kernel {'block ' + str(plan) if plan else 'no plan'}; "
                  f"cross step via attend -> flat kernel "
                  f"{plan is None and _MIN_WINNING_KEYS <= keys and flat_attention_viable(1, keys, 64)}")


if __name__ == "__main__":
    main()

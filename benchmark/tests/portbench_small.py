"""Small widths and a small split for running the benchmark's cells on the
CPU in the tests: the port takes each kernel's plain version there."""

import argparse
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for path in (str(BENCH), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

WIDTHS = {
    "mmf_m4c": {
        "MODEL.MMT.HIDDEN_SIZE": 32, "MODEL.MMT.NUM_ATTENTION_HEADS": 2,
        "MODEL.MMT.NUM_HIDDEN_LAYERS": 1, "MODEL.TEXT_BERT.HIDDEN_SIZE": 32,
        "MODEL.TEXT_BERT.NUM_HIDDEN_LAYERS": 1, "MODEL.D_MODEL": 32,
        "MODEL.OCR_PTR_NET.HIDDEN_SIZE": 32, "MODEL.OCR_PTR_NET.QUERY_KEY_SIZE": 32,
    },
}
DATA = {
    "DATASET.FEATURE_DATASET.BATCH_SIZE": 4, "DATASET.DICT_DATASET.BATCH_SIZE": 4,
    "DATASET.FEATURE_DATASET.WORKERS": 1, "DATASET.DICT_DATASET.WORKERS": 1,
    "DATASET.FEATURE_DATASET.MAX_SCENE_TEXT": 10, "DATASET.DICT_DATASET.MAX_SCENE_TEXT": 10,
}
# 100 regions: the datasets pad objects to 100 whatever the store holds
TRAFFIC = {"images": 12, "regions": 100, "ocr_tokens": [2, 9], "question_words": [2, 6],
           "answer_words": [1, 3], "traced_steps": 2, "traced_batches": 2, "checked_from": 3,
           "splits": {"train": 0.4, "dev": 0.4, "test": 0.2}}
SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds are


def config(name: str):
    """The small widths of a cell's or a configuration's name."""
    return {**DATA, **WIDTHS[name.split(".")[0]]}


def run(cell: str, trace: int = 0, seconds: float = 1.0, seed: int = SEED):
    """One run of `cell` on the CPU at small widths: the result line's dict."""
    from portbench import env, main

    env.prepare()
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    return main.execute(args, time.time(), device="cpu", config=config(cell), traffic=TRAFFIC)

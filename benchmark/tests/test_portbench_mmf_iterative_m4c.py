"""The mmf_iterative_m4c.eval_greedy cell on the CPU at small widths (its own,
below: 2 heads of 64, one encoder layer and the published 4 decoder layers;
the cell's files otherwise as they are): a sound run comes out
correct and a traced one reads every per-layer metric of the cell; a served
token altered and a decoder whose cross-attention reads the batch before's
encoder states come out not correct; and the configuration's model FLOPs equal torch's
FlopCounterMode over its reference."""

import argparse
import json
import time

import portbench_small as small
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import env, files, main

CELL = "mmf_iterative_m4c.eval_greedy"
CONFIG = "mmf_iterative_m4c"
WIDTHS = {
    "MODEL.D_MODEL": 128, "MODEL.ENCODER.D_MODEL": 128, "MODEL.ENCODER.HEAD": 2,
    "MODEL.ENCODER.LAYERS": 1, "MODEL.DECODER.D_MODEL": 128, "MODEL.DECODER.HEAD": 2,
    "MODEL.DECODER.LAYERS": 4, "MODEL.TEXT_BERT.HIDDEN_SIZE": 128,
    "MODEL.TEXT_BERT.NUM_HIDDEN_LAYERS": 1, "MODEL.TEXT_BERT.NUM_ATTENTION_HEADS": 2,
    "MODEL.OCR_PTR_NET.HIDDEN_SIZE": 128, "MODEL.OCR_PTR_NET.QUERY_KEY_SIZE": 128,
}
SPEC = json.loads((small.ROOT / "BENCHMARK.json").read_text())


def run(trace: int = 0):
    env.prepare()
    args = argparse.Namespace(workload=CELL, seed=small.SEED, seconds=1.0, trace=trace)
    return main.execute(args, time.time(), device="cpu", config={**small.DATA, **WIDTHS},
                        traffic=small.TRAFFIC)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(trace):
    result = run(trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if not trace:
        assert set(result["metrics"]) == {"eval_samples_per_s", "setup_s"}
        return
    names = {m["name"] for m in SPEC["per_layer"] if CELL in m.get("workloads", ())}
    # the CPU has no device trace: the kernels' share and the idle share need the card
    assert set(result["metrics"]) == names - {"kernel_roofline.iterative",
                                              "device_idle_share.iterative"}
    rows = result["metrics"]["cross_kv_rows.iterative"]["value"]
    batch = small.DATA["DATASET.DICT_DATASET.BATCH_SIZE"]
    assert rows > 0 and rows % (WIDTHS["MODEL.DECODER.LAYERS"] * batch) == 0
    for name in ("decoder_host_ms.iterative", "decode_step_ms.iterative",
                 "decode_host_ms.iterative"):
        assert result["metrics"][name]["value"] > 0.0, name
    assert result["metrics"]["decoder_host_ms.iterative"]["value"] \
        < result["metrics"]["decode_step_ms.iterative"]["value"]


def test_a_token_altered_where_it_is_produced_is_caught(monkeypatch):
    from openvivqa_tpu_torch.training.tasks.ocr_tasks import TrainingMMF

    greedy = TrainingMMF.greedy_ids

    def altered(self, device_batch):
        ids = greedy(self, device_batch).clone()
        ids[0, -1] = 1 + ids[0, -1] % 7  # another vocabulary word
        return ids

    monkeypatch.setattr(TrainingMMF, "greedy_ids", altered)
    result = run()
    assert not result["correct"]
    assert result["checks"]["served_gap"]["value"] > result["checks"]["served_gap"]["limit"]


def test_a_decoder_fed_stale_encoder_states_is_caught(monkeypatch):
    """The decoder's cross-attention reads the encoder states of the batch
    before (a cross-attention cache that was not renewed; the pointer net
    still reads the true ones).  Under random weights a cross-attention adds
    little to its residual, so the fault shows at the published depth and
    head size (4 layers, heads of 64) and not at 1 x 32.  Zeroing the OCR
    rows alone reads only 1.3 times the limit here: the 2-9 OCR tokens are a
    few percent of the ~120 keys the near-uniform attention averages."""
    from openvivqa_tpu_torch.models.mmf_variants import _IterativeM4CBase

    held = {}

    def stale(self, enc, i):
        if held.get("enc") is not enc:
            held["previous"] = held.get("current", enc["encoded"])
            held["enc"], held["current"] = enc, enc["encoded"]
        return held["previous"]

    monkeypatch.setattr(_IterativeM4CBase, "_cross_states", stale)
    result = run()
    assert not result["correct"]
    assert result["checks"]["score_gap"]["value"] > result["checks"]["score_gap"]["limit"]


# -- the model FLOPs -------------------------------------------------------------------------------
SHAPES = {"question": 7, "answer": 5, "vocab": 30, "regions": 6, "ocr": 4}
D_OBJECT, D_OCR = 24, 20


def small_config():
    return {**files.load_json(small.BENCH / "configs" / f"{CONFIG}.json"), **WIDTHS,
            "MODEL.OBJECT_EMBEDDING.D_FEATURE": D_OBJECT, "MODEL.OCR_EMBEDDING.D_FEATURE": D_OCR}


def small_batch(answer: int, b: int = 2):
    g = torch.Generator().manual_seed(0)
    vocab, q, regions, ocr = (SHAPES[k] for k in ("vocab", "question", "regions", "ocr"))
    return {
        "question_tokens": torch.randint(1, vocab, (b, q), generator=g),
        "region_features": torch.randn(b, regions, D_OBJECT, generator=g),
        "region_boxes": torch.rand(b, regions, 4, generator=g),
        "ocr_fasttext_features": torch.randn(b, ocr, 8, generator=g),
        "ocr_rec_features": torch.randn(b, ocr, 6, generator=g),
        "ocr_det_features": torch.randn(b, ocr, 6, generator=g),
        "ocr_boxes": torch.rand(b, ocr, 4, generator=g),
        "answer_tokens": torch.randint(1, vocab, (b, answer), generator=g),
        "shifted_right_answer_tokens": torch.randint(1, vocab, (b, answer), generator=g),
        "sample_valid": torch.ones(b),
    }


class Weights(dict):
    """Every weight the reference reads, made at the shape it reads it at the
    first time it asks (by the port's parameter names)."""

    def __init__(self, width: int):
        super().__init__()
        self.width = width

    def shape(self, name):
        h = self.width
        if name.endswith("_embeddings.weight"):
            return (64, h)
        if name.startswith("classifier."):
            return (SHAPES["vocab"], h) if name.endswith("weight") else (SHAPES["vocab"],)
        if name == "linear_obj_feat_to_mmt_in.weight":
            return (h, D_OBJECT)
        if name == "linear_ocr_feat_to_mmt_in.weight":
            return (h, D_OCR)
        if name.endswith("bbox_to_mmt_in.weight"):
            return (h, 4)
        if name.endswith("intermediate.dense.weight"):
            return (4 * h, h)
        if name.endswith("intermediate.dense.bias"):
            return (4 * h,)
        if name.endswith("output.dense.weight") and "attention." not in name:
            return (h, 4 * h)
        if name.endswith(".weight") and "orm" not in name:
            return (h, h)
        return (h,)

    def __missing__(self, name):
        value = (torch.randn(self.shape(name)) * 0.02).requires_grad_(True)
        self[name] = value
        return value


def counted(config, batch, answer_rows: int, backward: bool = False) -> float:
    from reference import plain

    reference = files.reference(CONFIG)
    model = reference.Model(config)
    blocks = plain.Blocks(Weights(WIDTHS["MODEL.D_MODEL"]), plain.Precision("fp32"), None)
    prefix = batch["answer_tokens"][:, :answer_rows]
    model.scores(blocks, batch, prefix)  # every weight made
    with FlopCounterMode(display=False) as counter:
        scores = model.scores(blocks, batch, prefix)
        if backward:
            plain.xe_loss(scores, {**batch, "shifted_right_answer_tokens":
                                   batch["shifted_right_answer_tokens"][:, :answer_rows]}
                          ).backward()
    return counter.get_total_flops()


def test_forward_and_train_flops_match_the_flop_counter():
    config, batch = small_config(), small_batch(SHAPES["answer"])
    count = files.model_work(CONFIG).flops(config, SHAPES)
    assert counted(config, batch, SHAPES["answer"]) == 2 * count["forward"]
    assert counted(config, batch, SHAPES["answer"], backward=True) == 2 * count["train"]


def test_eval_flops_are_one_encode_the_cross_keys_and_values_and_the_steps():
    """The needed work is the teacher-forced forward's, which projects each
    decoder layer's cross-attention keys and values once, less the attention
    a decode never needs: answer rows over later answer rows (the causal
    mask's upper triangle).  (At two answer steps: at one, torch computes a
    product over a single key without a counted matmul.)"""
    steps = 2
    config, batch = small_config(), small_batch(steps)
    count = files.model_work(CONFIG).flops(config, dict(SHAPES, answer=steps))
    unneeded = steps * steps - steps * (steps + 1) // 2
    layers, width = WIDTHS["MODEL.DECODER.LAYERS"], WIDTHS["MODEL.D_MODEL"]
    assert counted(config, batch, steps) == 2 * (count["eval"] + layers * 4.0 * width * unneeded)

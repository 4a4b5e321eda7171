"""The operation and byte counts: each configuration's model FLOPs against
torch's FlopCounterMode over its reference, and a kernel entry's bound
against PERF.md's table."""

import portbench_small as small
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import files, program
from portbench.main import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

SHAPES = {"question": 7, "answer": 5, "vocab": 30, "regions": 6, "ocr": 4}


def reference_inputs(config_name, answer):
    """A small batch and the configuration file at small widths (every
    configuration file under benchmark/configs/, with or without a cell)."""
    config = {**files.load_json(small.BENCH / "configs" / f"{config_name}.json"),
              **small.config(config_name),
              "MODEL.OBJECT_EMBEDDING.D_FEATURE": 24, "MODEL.OCR_EMBEDDING.D_FEATURE": 20}
    b, shapes = 2, dict(SHAPES, answer=answer)
    g = torch.Generator().manual_seed(0)
    batch = {
        "question_tokens": torch.randint(1, shapes["vocab"], (b, shapes["question"]), generator=g),
        "region_features": torch.randn(b, shapes["regions"], 24, generator=g),
        "region_boxes": torch.rand(b, shapes["regions"], 4, generator=g),
        "ocr_fasttext_features": torch.randn(b, shapes["ocr"], 8, generator=g),
        "ocr_rec_features": torch.randn(b, shapes["ocr"], 6, generator=g),
        "ocr_det_features": torch.randn(b, shapes["ocr"], 6, generator=g),
        "ocr_boxes": torch.rand(b, shapes["ocr"], 4, generator=g),
        "answer_tokens": torch.randint(1, shapes["vocab"], (b, answer), generator=g),
        "shifted_right_answer_tokens": torch.randint(1, shapes["vocab"], (b, answer), generator=g),
        "sample_valid": torch.ones(b),
    }
    return config, shapes, batch, b


def weights_for(reference_module, config, shapes):
    """The reference's parameters: every name its forward reads, with the
    shape it reads it at, found by running it on a recording dict."""
    h = int(config["MODEL.MMT.HIDDEN_SIZE"])

    class Lazy(dict):
        def __missing__(self, name):
            if name.startswith("text_bert.embeddings.") and name.endswith("_embeddings.weight"):
                shape = (64, h)
            elif name == "classifier.weight":
                shape = (shapes["vocab"], h)
            elif name in ("linear_obj_feat_to_mmt_in.weight",):
                shape = (h, 24)
            elif name in ("linear_ocr_feat_to_mmt_in.weight",):
                shape = (h, 20)
            elif name.endswith("bbox_to_mmt_in.weight"):
                shape = (h, 4)
            elif "position_embeddings" in name or "token_type_embeddings" in name:
                shape = (64, h)
            elif name.endswith("intermediate.dense.weight"):
                shape = (4 * h, h)
            elif name.endswith("output.dense.weight") and ".attention." not in name \
                    and "crossattention" not in name:
                shape = (h, 4 * h)
            elif name.endswith(".weight") and ("LayerNorm" in name or "layer_norm" in name):
                shape = (h,)
            elif name.endswith(".weight"):
                shape = (h, h)
            elif name == "classifier.bias":
                shape = (shapes["vocab"],)
            else:
                shape = (4 * h,) if "intermediate" in name else (h,)
            value = (torch.randn(shape) * 0.02).requires_grad_(True)
            self[name] = value
            return value

    return Lazy()


@pytest.mark.parametrize("config_name", ["mmf_m4c"])
def test_model_flops_match_the_flop_counter(config_name):
    from reference import plain

    config, shapes, batch, b = reference_inputs(config_name, SHAPES["answer"])
    reference = files.reference(config_name)
    count = files.model_work(config_name).flops(config, shapes)
    weights = weights_for(reference, config, shapes)
    model = reference.Model(config)
    blocks = plain.Blocks(weights, plain.Precision("fp32"), None)
    model.scores(blocks, batch, batch["answer_tokens"])  # every weight created
    with FlopCounterMode(display=False) as forward_counter:
        scores = model.scores(blocks, batch, batch["answer_tokens"])
    assert forward_counter.get_total_flops() == b * count["forward"]
    with FlopCounterMode(display=False) as train_counter:
        scores = model.scores(blocks, batch, batch["answer_tokens"])
        plain.xe_loss(scores, batch).backward()
    assert train_counter.get_total_flops() == b * count["train"]


@pytest.mark.parametrize("config_name", ["mmf_m4c"])
def test_eval_flops_are_one_encode_and_the_steps(config_name):
    """The needed work is the teacher-forced forward's, less the attention it
    does and a decode never needs: answer rows over later answer rows (the
    causal mask's upper triangle) and, in MMF_M4C's joint encoder, the
    context rows over the answer rows.  (At two answer steps: at one, torch
    computes a product over a single key without a counted matmul.)"""
    from reference import plain

    steps = 2
    config, shapes, batch, b = reference_inputs(config_name, steps)
    reference = files.reference(config_name)
    count = files.model_work(config_name).flops(config, shapes)
    weights = weights_for(reference, config, shapes)
    blocks = plain.Blocks(weights, plain.Precision("fp32"), None)
    prefix = batch["answer_tokens"][:, :steps]
    reference.Model(config).scores(blocks, batch, prefix)
    with FlopCounterMode(display=False) as counter:
        reference.Model(config).scores(blocks, batch, prefix)
    context = shapes["question"] + shapes["regions"] + shapes["ocr"]
    unneeded = steps * steps - steps * (steps + 1) // 2 + context * steps
    layers, width = int(config["MODEL.MMT.NUM_HIDDEN_LAYERS"]), int(config["MODEL.MMT.HIDDEN_SIZE"])
    assert counter.get_total_flops() == b * (count["eval"] + layers * 4.0 * width * unneeded)


def test_dropout_forward_bound_is_perf_row_5():
    """PERF.md's kernel table, row 5: the MMT's dropout attention at 64 x 215,
    8 heads of 96, a per-sample (64, 1, 215, 215) bias: bound 0.0540 ms by
    bytes."""
    work = files.entry_works()["fused_attention_packed_dropout"]
    meta = {"device": "meta"}
    q, k, v = (torch.empty(64, 215, 768, **meta) for _ in range(3))
    bias = torch.empty(64, 1, 215, 215, **meta)
    seed = torch.empty(1, dtype=torch.int64, **meta)
    flops, nbytes = work.forward((q, k, v, bias, seed, 0.1, 8, 0.1), {}, torch.empty_like(q))
    bound_ms = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    assert nbytes / PEAK_HBM_BYTES > flops / PEAK_BF16_FLOPS
    assert round(bound_ms, 4) == 0.0540


def test_weights_are_the_same_for_any_module_order():
    shapes = [("b.weight", (3, 2)), ("a.bias", (4,)), ("a.LayerNorm.weight", (4,))]
    one = program.draw_weights(shapes, 7, "cpu")
    two = program.draw_weights(list(reversed(shapes)), 7, "cpu")
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert abs(float(one["a.LayerNorm.weight"].mean()) - 1.0) < 0.1
    assert not torch.equal(one["b.weight"], program.draw_weights(shapes, 8, "cpu")["b.weight"])

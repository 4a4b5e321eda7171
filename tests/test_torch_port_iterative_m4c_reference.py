"""The port's MMF_IterativeM4C against the benchmark's plain float32 reference
(``benchmark/reference/mmf_iterative_m4c.py``) on seeded random weights, at
small widths (2 heads of 32, 2 encoder and 2 decoder layers) from the
benchmark's configuration file, on the CPU, where the port runs each
kernel's plain version in float32.

Held: the teacher-forced scores; each quadratic greedy step's scores along
the port's own prefixes; the incremental decode (kernels A, E and C per
decoder step, and the modules' plain route) along its own prefix, which its
docstring says equals the quadratic greedy, and whose ids the quadratic
greedy's equal; and, with dropout drawn from one seed, the training scores,
loss and first gradients that the reference's ``train_readings`` gives.

Scores are compared over the largest |reference score|, gradient norms over
their own (or a thousandth of the largest), each within 2e-6: the port sums
in another order (fused q|k|v products, the plain kernels' softmax and
LayerNorm, the pointer's keys projected once), which reads 0.9-2.0e-7 here,
while the reference with every product in bf16 reads 3.1e-3.  The loss
within 1e-6 relative (it reads 0).
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from openvivqa_tpu_torch.builders import META_ARCHITECTURE, populate
from openvivqa_tpu_torch.config import ConfigNode

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT / "benchmark"))

from reference import mmf_iterative_m4c as reference  # noqa: E402
from reference import plain  # noqa: E402

populate()

H, HEADS, VOCAB, T = 64, 2, 25, 6
Q, N_OBJ, N_OCR, B = 7, 5, 4, 3
D_OBJ, D_FT, D_REC, D_DET = 12, 10, 6, 4
SEED = 2**31 + 101
SCORE_RTOL = 2e-6
GRAD_RTOL = 2e-6

CONFIG = {
    **json.loads((ROOT / "benchmark" / "configs" / "mmf_iterative_m4c.json").read_text()),
    "MODEL.D_MODEL": H, "MODEL.ENCODER.D_MODEL": H, "MODEL.ENCODER.HEAD": HEADS,
    "MODEL.ENCODER.LAYERS": 2, "MODEL.DECODER.D_MODEL": H, "MODEL.DECODER.HEAD": HEADS,
    "MODEL.DECODER.LAYERS": 2, "MODEL.TEXT_BERT.HIDDEN_SIZE": H,
    "MODEL.TEXT_BERT.NUM_HIDDEN_LAYERS": 1, "MODEL.TEXT_BERT.NUM_ATTENTION_HEADS": HEADS,
    "MODEL.OCR_PTR_NET.HIDDEN_SIZE": H, "MODEL.OCR_PTR_NET.QUERY_KEY_SIZE": H,
    "MODEL.OBJECT_EMBEDDING.D_FEATURE": D_OBJ,
    "MODEL.OCR_EMBEDDING.D_FEATURE": D_FT + D_REC + D_DET,
}


class Vocab:
    padding_idx, bos_idx, eos_idx, unk_idx = 0, 1, 2, 3
    max_answer_length = T

    def __len__(self):
        return VOCAB


def model_node(**extra):
    """The configuration file's MODEL keys as the port's nested node."""
    node = {}
    for key, value in CONFIG.items():
        if not key.startswith("MODEL."):
            continue
        *parents, leaf = key.split(".")[1:]
        at = node
        for part in parents:
            at = at.setdefault(part, {})
        at[leaf] = value
    return ConfigNode({**node, **extra})


def port_model(**extra):
    """MMF_IterativeM4C with weights drawn from SEED: normal(0, 0.05) for
    matrices, tables and biases, 1 + normal(0, 0.05) for LayerNorm scales
    (wider than the benchmark's 0.02, so that every sublayer moves the
    scores)."""
    model = META_ARCHITECTURE.get("MMF_IterativeM4C")(model_node(**extra), Vocab())
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, param in sorted(model.named_parameters()):
            value = torch.randn(param.shape, generator=g) * 0.05
            if param.ndim == 1 and name.endswith(".weight"):
                value += 1.0
            param.copy_(value)
    return model.eval()


def weights_of(model):
    return {name: param.detach().clone() for name, param in model.named_parameters()}


def batch():
    g = torch.Generator().manual_seed(7)
    q = torch.randint(4, VOCAB, (B, Q), generator=g)
    q[0, -2:] = 0  # padded question tokens
    out = {
        "question_tokens": q,
        "region_features": torch.randn(B, N_OBJ, D_OBJ, generator=g),
        "region_boxes": torch.rand(B, N_OBJ, 4, generator=g),
        "ocr_fasttext_features": torch.randn(B, N_OCR, D_FT, generator=g),
        "ocr_rec_features": torch.randn(B, N_OCR, D_REC, generator=g),
        "ocr_det_features": torch.randn(B, N_OCR, D_DET, generator=g),
        "ocr_boxes": torch.rand(B, N_OCR, 4, generator=g),
        "answer_tokens": torch.randint(4, VOCAB + N_OCR, (B, T), generator=g),
        "sample_valid": torch.ones(B),
    }
    out["answer_tokens"][:, 0] = Vocab.bos_idx
    out["shifted_right_answer_tokens"] = torch.cat(
        [out["answer_tokens"][:, 1:], torch.zeros((B, 1), dtype=torch.long)], dim=1)
    # padded object and OCR rows exercise the encoder's and the pointer's biases
    out["region_features"][1, -1] = 0.0
    for key in ("ocr_fasttext_features", "ocr_rec_features", "ocr_det_features"):
        out[key][2, -2:] = 0.0
    return out


def assert_scores_close(got, want):
    live = reference.live_scores(want)
    assert torch.equal(reference.live_scores(got), live)
    scale = float(want.abs()[live].max())
    gap = float((got - want).abs()[live].max()) / scale
    assert gap <= SCORE_RTOL, gap


def test_teacher_forced_scores_match_the_reference():
    model, inputs = port_model(), batch()
    got = model(inputs)["scores"]
    want = reference.step_scores(CONFIG, weights_of(model), inputs, inputs["answer_tokens"])
    assert got.shape == (B, T, VOCAB + N_OCR)
    assert_scores_close(got, want)


def quadratic_steps(model, inputs):
    """Each quadratic greedy step's answer prefix and scores, and the ids."""
    prefixes, scores = [], []
    update = model._update_prev_inds

    def capture(prev_inds, step_scores, step):
        prefixes.append(prev_inds.clone())
        scores.append(step_scores)
        return update(prev_inds, step_scores, step)

    model._update_prev_inds = capture
    try:
        out = model.greedy_decode(inputs)
    finally:
        del model._update_prev_inds
    return prefixes, scores, out


def test_each_quadratic_greedy_step_matches_the_reference():
    model, inputs = port_model(), batch()
    weights = weights_of(model)
    prefixes, scores, _ = quadratic_steps(model, inputs)
    assert len(prefixes) == T
    for prefix, got in zip(prefixes, scores):
        assert_scores_close(got, reference.step_scores(CONFIG, weights, inputs, prefix))


@pytest.mark.parametrize("route", ["layer", "none"])
def test_the_incremental_decode_matches_the_reference_and_the_quadratic_greedy(
        route, monkeypatch):
    """Kernels A, E and C (their plain versions here) or, with
    OPENVIVQA_DECODE_KERNEL_PARTS=none, the modules' plain route: step t's
    scores are the reference's row t over the decode's own prefix, and the
    ids are the quadratic greedy's."""
    monkeypatch.setenv("OPENVIVQA_DECODE_KERNEL_PARTS", route)
    quadratic = port_model()
    inputs = batch()
    _, _, want = quadratic_steps(quadratic, inputs)
    model = port_model(DECODING_MODE="incremental")
    got = model.greedy_decode(inputs)
    np.testing.assert_array_equal(got["prev_inds"].numpy(), want["prev_inds"].numpy())
    ref = reference.step_scores(CONFIG, weights_of(model), inputs, got["prev_inds"])
    assert_scores_close(got["scores"], ref)
    assert_scores_close(got["scores"], want["scores"])


def test_training_scores_loss_and_gradients_match_the_reference():
    """Dropout 0.1 drawn from one generator in the order the model reads it,
    the attention weights' masks included: the port's training scores equal
    the reference's under the same stream, and its loss and each leaf's
    first gradient norm equal ``train_readings``'s."""
    model, inputs = port_model(), batch()
    weights = weights_of(model)
    model.train()
    scores = model(inputs, generator=torch.Generator().manual_seed(SEED))["scores"]
    with torch.no_grad():
        f = plain.Blocks(weights, plain.Precision("fp32"), plain.Dropout(SEED, "cpu"))
        want = reference.Model(CONFIG).scores(f, inputs, inputs["answer_tokens"])
        clean = reference.step_scores(CONFIG, weights, inputs, inputs["answer_tokens"])
    assert_scores_close(scores.detach(), want)
    live = reference.live_scores(clean)
    moved = float((want - clean).abs()[live].max()) / float(clean.abs()[live].max())
    assert moved > 100 * SCORE_RTOL, moved  # the dropout drawn does move the scores
    loss = plain.xe_loss(scores, inputs)
    loss.backward()
    readings = reference.train_readings(CONFIG, weights, [inputs], SEED)
    assert abs(float(loss) - readings["loss"][0]) <= 1e-6 * abs(readings["loss"][0])
    norms = readings["grad_norms"]
    largest = max(norms.values())
    for name, param in model.named_parameters():
        got = 0.0 if param.grad is None else float(param.grad.norm())
        assert abs(got - norms[name]) <= GRAD_RTOL * max(norms[name], 1e-3 * largest), name

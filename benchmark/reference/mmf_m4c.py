"""Plain reference of MMF_M4C (M4C, Hu et al., arXiv:1911.06258, as the
OpenViVQA ``mmf_m4c.py`` builds it): a BERT question encoder (TextBert), the
object and OCR feature encodings, the multimodal transformer (MMT) over
[question, objects, OCR tokens, previous answer tokens] under M4C's mask
(every row sees every unpadded column; the answer rows causally among
themselves), and the classifier plus the OCR pointer net on the answer rows.

As upstream runs it, TextBert takes the MMT's head count and trains: the
upstream model reads neither TEXT_BERT.NUM_ATTENTION_HEADS nor
TEXT_BERT.FREEZE_WEIGHTS (see the configuration file's notes).

Weights are held by the reference checkpoints' parameter names.  Training is
teacher-forced with dropout 0.1 (the stream of ``plain.Dropout``); the greedy
decode's step t is this forward over that step's answer prefix, without
dropout.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from reference import data, plain


def read_split(config: Dict, paths: Dict[str, str]) -> data.Split:
    """The split as this reference reads it: OCR tokens padded to
    MAX_SCENE_TEXT, objects to MAX_REGIONS (the datasets' default 100)."""
    keys = "DATASET.FEATURE_DATASET."
    return data.Split(paths, int(config[keys + "MAX_SCENE_TEXT"]),
                      int(config.get(keys + "MAX_REGIONS") or 100))


def shapes(config: Dict, traffic: Dict, split: data.Split) -> Dict[str, int]:
    """The token counts a sample's FLOPs follow (``benchmark/work/models``)."""
    return {"question": split.max_question, "answer": split.max_answer, "vocab": len(split),
            "regions": split.max_regions, "ocr": split.max_scene_text}


def live_scores(scores: torch.Tensor) -> torch.Tensor:
    """The candidates a decode step can choose: all but the OCR pointer's
    masked (padded) slots."""
    return scores > 0.1 * plain.MASK_VALUE


class Model:
    def __init__(self, config: Dict):
        self.text_layers = int(config["MODEL.TEXT_BERT.NUM_HIDDEN_LAYERS"])
        self.layers = int(config["MODEL.MMT.NUM_HIDDEN_LAYERS"])
        self.heads = int(config["MODEL.MMT.NUM_ATTENTION_HEADS"])
        self.hidden = int(config["MODEL.MMT.HIDDEN_SIZE"])
        self.text_hidden = int(config["MODEL.TEXT_BERT.HIDDEN_SIZE"])
        self.d_model = int(config["MODEL.D_MODEL"])

    def encode_question(self, f: plain.Blocks, batch):
        bias = plain.padding_bias(batch["question_tokens"], 0)
        x = f.bert_embeddings(batch["question_tokens"].long(), "text_bert.embeddings")
        x = f.bert_stack(x, bias, "text_bert.encoder", self.text_layers, self.heads)
        if self.hidden != 768 or self.text_hidden != self.hidden:
            x = f.linear(x, "text_bert_out_linear")
        return x, bias

    def scores(self, f: plain.Blocks, batch, prev_inds: torch.Tensor) -> torch.Tensor:
        """(b, T, V + K) scores of the answer rows given `prev_inds`."""
        txt, txt_bias = self.encode_question(f, batch)
        obj = f.feature_box(batch["region_features"], batch["region_boxes"], "obj")
        obj_bias = plain.padding_bias(batch["region_features"])
        ocr = f.feature_box(plain.ocr_features(batch), batch["ocr_boxes"], "ocr")
        ocr_bias = plain.ocr_bias(batch)
        dec = f.prev_pred_embeddings(ocr, prev_inds.long(), "mmt.prev_pred_embeddings")
        b, t = dec.shape[:2]
        x = torch.cat([txt, obj, ocr, dec], dim=1)
        total = x.shape[1]
        cols = torch.cat([txt_bias, obj_bias, ocr_bias,
                          torch.zeros((b, 1, 1, t), device=x.device)], dim=-1)
        bias = cols.expand(b, 1, total, total).clone()
        causal = torch.triu(torch.full((t, t), plain.MASK_VALUE, device=x.device), 1)
        bias[:, :, -t:, -t:] = causal
        x = f.bert_stack(x, bias, "mmt.encoder", self.layers, self.heads)
        begin = txt.shape[1] + obj.shape[1]
        return f.scores(x[:, -t:], x[:, begin:begin + ocr.shape[1]], ocr_bias)


def train_readings(config: Dict, weights: Dict[str, torch.Tensor], batches, seed: int,
                   precision: str = "fp32", fault: Optional[str] = None) -> Dict:
    """The readings of len(batches) training steps from `weights` with the
    dropout stream of TRAINING.SEED `seed` (see ``plain.train_readings``).
    `fault` "half_batch" takes the loss over the first half of the rows only."""
    model = Model(config)
    device = next(iter(weights.values())).device
    drop = plain.Dropout(seed, device)
    p = plain.Precision(precision)

    def loss_fn(w, batch):
        f = plain.Blocks(w, p, drop)
        scores = model.scores(f, batch, batch["answer_tokens"])
        if fault == "half_batch":
            batch = dict(batch)
            rows = torch.arange(batch["sample_valid"].shape[0], device=device)
            batch["sample_valid"] = batch["sample_valid"] * (rows < rows.numel() // 2)
        return plain.xe_loss(scores, batch)

    factor = plain.noam(model.d_model, int(config["TRAINING.WARMUP"]))
    with plain.float32_products():
        return plain.train_readings(loss_fn, weights, batches,
                                    float(config["TRAINING.LEARNING_RATE"]), factor)


@torch.no_grad()
def step_scores(config: Dict, weights: Dict[str, torch.Tensor], batch, prev_inds,
                precision: str = "fp32") -> torch.Tensor:
    """The greedy decode's scores at one step: the forward over that step's
    answer prefix `prev_inds`, without dropout."""
    with plain.float32_products():
        f = plain.Blocks(weights, plain.Precision(precision), None)
        return Model(config).scores(f, batch, prev_inds)

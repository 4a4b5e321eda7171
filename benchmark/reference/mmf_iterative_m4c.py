"""Plain reference of MMF_IterativeM4C (OpenViVQA ``models/mmf_iterative_m4c.py:13-270``,
after M4C, Hu et al., arXiv:1911.06258): M4C's multimodal transformer split in
two.  A BERT question encoder (TextBert); the object and OCR feature
encodings; a joint BERT encoder over [question, objects, OCR tokens] under
their key-padding bias; then a BERT decoder over the previous answer tokens,
each layer post-LN: causal self-attention over the answer prefix,
cross-attention over the encoder's last states under the encoder's bias, and
the FFN; then the classifier and the OCR pointer net (over the encoder's OCR
rows) on the decoder's rows.

Weights are held by the port's parameter names (the reference checkpoints'):
``text_bert.*``, ``encoder.layer.<i>.*``, ``prev_pred_embeddings.*``,
``decoder.layer.<i>.{attention,crossattention,intermediate,output}.*``,
``classifier``, ``ocr_ptr_net``.  Training is teacher-forced with dropout 0.1
(the stream of ``plain.Dropout``, drawn in the order the model reads it: the
question, objects and OCR tokens, the encoder, the answer embeddings, then
each decoder layer's self-attention, cross-attention and FFN); the greedy
decode's step t is this forward over that step's answer prefix, without
dropout, which re-runs the decoder over the whole prefix.

Departures from upstream, each as the JAX package and the port have them:
  * TextBert is projected to the model's width only where the widths differ
    (upstream's file has no projection and would fail there); at the
    published 512 / 512 there is none.
  * TextBert and the decoder take the encoder's head count
    (MODEL.ENCODER.HEAD); MODEL.DECODER.HEAD and
    MODEL.TEXT_BERT.NUM_ATTENTION_HEADS are not read (8 in the published
    configuration, as the encoder's).
  * Upstream's package never registers the model (its ``models/__init__.py``
    comments the import out), so its configuration does not build there.
The two departures noted for the standalone IterativeM4C (an encoder without
attention-weight dropout, an incremental prefix normalised twice) are not
this model's: here the encoder's attention weights are dropped out as every
BERT layer's, and the prefix is normalised once.
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
        self.hidden = int(config["MODEL.ENCODER.D_MODEL"])
        self.heads = int(config["MODEL.ENCODER.HEAD"])
        self.encoder_layers = int(config["MODEL.ENCODER.LAYERS"])
        self.decoder_layers = int(config["MODEL.DECODER.LAYERS"])
        self.text_layers = int(config["MODEL.TEXT_BERT.NUM_HIDDEN_LAYERS"])
        self.text_hidden = int(config["MODEL.TEXT_BERT.HIDDEN_SIZE"])
        self.d_model = int(config["MODEL.D_MODEL"])

    def encode(self, f: plain.Blocks, batch):
        """The joint encoder's last states over [question, objects, OCR], their
        (b, 1, 1, S) bias, the OCR rows' slice, the OCR encodings and bias."""
        txt_bias = plain.padding_bias(batch["question_tokens"], 0)
        txt = f.bert_embeddings(batch["question_tokens"].long(), "text_bert.embeddings")
        txt = f.bert_stack(txt, txt_bias, "text_bert.encoder", self.text_layers, self.heads)
        if self.text_hidden != self.hidden:
            txt = f.linear(txt, "text_bert_out_linear")
        obj = f.feature_box(batch["region_features"], batch["region_boxes"], "obj")
        ocr = f.feature_box(plain.ocr_features(batch), batch["ocr_boxes"], "ocr")
        ocr_bias = plain.ocr_bias(batch)
        bias = torch.cat([txt_bias, plain.padding_bias(batch["region_features"]), ocr_bias],
                         dim=-1)
        states = f.bert_stack(torch.cat([txt, obj, ocr], dim=1), bias, "encoder",
                              self.encoder_layers, self.heads)
        begin = txt.shape[1] + obj.shape[1]
        return states, bias, slice(begin, begin + ocr.shape[1]), ocr, ocr_bias

    def scores(self, f: plain.Blocks, batch, prev_inds: torch.Tensor) -> torch.Tensor:
        """(b, T, V + K) scores of the answer rows given `prev_inds`."""
        states, bias, ocr_rows, ocr, ocr_bias = self.encode(f, batch)
        dec = f.prev_pred_embeddings(ocr, prev_inds.long(), "prev_pred_embeddings")
        t = dec.shape[1]
        causal = torch.triu(torch.full((t, t), plain.MASK_VALUE, device=dec.device), 1)
        dec = f.bert_stack(dec, causal[None, None], "decoder", self.decoder_layers, self.heads,
                           cross=states, cross_bias=bias)
        return f.scores(dec, states[:, ocr_rows], ocr_bias)


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

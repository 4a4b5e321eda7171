"""OCR tasks: OcrOpenEndedTask (OpenEndedTask with OCR-copy answer decoding),
TrainingMMF's XE train step, greedy evaluation and test predictions (and its
alias TrainingM4C), and MmfClassificationTask (LoRRA's classification over the
answers and the OCR slots).

Counterpart of ``openvivqa_tpu/training/tasks/ocr_tasks.py``.  Greedy ids are
argmaxed on the device; only (bs, T) ids cross to the host, where
``compute_scores`` scores them.
"""

from __future__ import annotations

import numpy as np
import torch

from ...builders import META_TASK
from ...evaluation import compute_scores
from ...logging_utils import setup_logger
from ..train_state import bce_with_logits_loss, nll_loss
from .classification_task import ClassificationTask
from .open_ended_task import OpenEndedTask, _pad_tables

logger = setup_logger()


@META_TASK.register()
class OcrOpenEndedTask(OpenEndedTask):
    """Generative VQA with OCR copying: answers decode against each sample's
    OCR table (OpenEndedTask does so whenever the batch carries one)."""


@META_TASK.register()
class TrainingMMF(OcrOpenEndedTask):
    """MMF-ported M4C: XE training on teacher-forced scores, greedy-decode
    evaluation and predictions."""

    def compute_loss(self, batch) -> torch.Tensor:
        """NLL of log_softmax(scores) against the shifted answers, weighted by
        sample_valid so that batch-padding rows count for nothing."""
        scores = self.model(batch, generator=self.generator)["scores"]
        logprobs = torch.log_softmax(scores, dim=-1)
        targets = batch["shifted_right_answer_tokens"]
        weights = batch["sample_valid"][:, None].expand(targets.shape)
        return nll_loss(logprobs.reshape(-1, logprobs.shape[-1]), targets.reshape(-1),
                        self.vocab.padding_idx, weights=weights.reshape(-1))

    @torch.no_grad()
    def greedy_ids(self, device_batch) -> torch.Tensor:
        """(bs, T) int32 greedy ids, argmaxed on the device."""
        scores = self.model.greedy_decode(device_batch)["scores"]
        return scores.argmax(dim=-1).to(torch.int32)

    def answer_ids(self, device_batch) -> torch.Tensor:
        """Greedy ids."""
        return self.greedy_ids(device_batch)

    def train_scst(self):
        raise NotImplementedError(
            "SCST applies to beam-searchable models, not the greedy MMF path")

    def get_predictions(self):
        """Greedy predictions on the test split from best_model.pth, with
        each token's provenance (fixed vocab or OCR), into test_results.json."""
        self.load_best_model()

        results, overall_gens, overall_gts = [], {}, {}
        with self.eval_weights():
            test_ids = [(batch, self.greedy_ids(device_batch).cpu().numpy())
                        for batch, device_batch in self.device_batches(self.test_dict_dataloader)]
        for it, (batch, ids) in enumerate(test_ids):
            valid = np.asarray(batch["sample_valid"])
            n_real = int(valid.sum())
            answers_gen, in_fixed = self.vocab.decode_answer_with_determination(
                ids[:n_real], batch["ocr_tokens"], join_words=True
            )
            gens, gts = {}, {}
            for i, (gts_i, gen_i) in enumerate(zip(batch["answers"][:n_real], answers_gen)):
                key = f"{it}_{i}"
                gens[key] = gen_i
                gts[key] = gts_i
                overall_gens[key] = [gen_i]
                overall_gts[key] = gts_i
            results.append({
                "id": [int(x) for x in np.asarray(batch["question_id"])[valid]],
                "filename": [f for f, v in zip(batch["filename"], valid) if v],
                "gens": gens,
                "gts": gts,
                "in_fixed_vocab": in_fixed,
            })

        scores, _ = compute_scores(overall_gts, overall_gens)
        logger.info("Evaluation scores on test: %s", scores)
        self.dump_json("test_results.json", {"results": results, **scores})
        return scores


@META_TASK.register()
class TrainingM4C(TrainingMMF):
    """The reference's M4C task: TrainingMMF's training and greedy eval."""


@META_TASK.register()
class MmfClassificationTask(ClassificationTask):
    """LoRRA's classification over the answers and the OCR slots: the BCE of
    the model's scores against the one-hot class ids (batch-padding rows count
    for nothing), argmax predictions, and answers decoded against each
    sample's OCR table.  The loops are ClassificationTask's."""

    def compute_loss(self, batch) -> torch.Tensor:
        self.model.train()
        scores = self.model(batch, generator=self.generator)["scores"]
        return bce_with_logits_loss(scores, batch["answer"].reshape(-1),
                                    weights=batch["sample_valid"])

    def class_scores(self, batch) -> torch.Tensor:
        return self.model(batch)["scores"]

    def _decode_eval(self, preds: np.ndarray, batch):
        ocr_tokens = _pad_tables(batch["ocr_tokens"], preds.shape[0])
        answers_gt = self.vocab.decode_answer(batch["answer"].reshape(-1), ocr_tokens,
                                              join_word=True)
        answers_gen = self.vocab.decode_answer(preds, ocr_tokens, join_word=True)
        return answers_gt, answers_gen

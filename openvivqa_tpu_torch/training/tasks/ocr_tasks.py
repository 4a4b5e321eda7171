"""OCR tasks, eval part: OCR-copy answer decoding and TrainingMMF's greedy
evaluation.

Counterpart of ``OcrOpenEndedTask._decode_batch`` and
``TrainingMMF.evaluate_metrics`` in ``openvivqa_tpu/training/tasks/ocr_tasks.py``.
Greedy ids are argmaxed on the device; only (bs, T) ids cross to the host,
where the shared ``openvivqa_tpu.evaluation.compute_scores`` scores them.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from openvivqa_tpu.evaluation import compute_scores

from ...builders import META_TASK
from .base_task import BaseTask


def _pad_tables(ocr_tokens, n_rows):
    """Extend per-sample OCR tables to the padded batch size (padding rows
    reuse the last table; sample_valid drops them)."""
    tables = list(ocr_tokens)
    if tables and len(tables) < n_rows:
        tables += [tables[-1]] * (n_rows - len(tables))
    return tables


class OcrOpenEndedTask(BaseTask):
    """Generative VQA with OCR copying: answers decode against each sample's
    OCR table."""

    def _decode_batch(self, outs: np.ndarray, batch) -> list:
        """(bs, T) ids -> answer strings, consecutive repeats merged."""
        ocr_tokens = _pad_tables(batch["ocr_tokens"], outs.shape[0])
        token_lists = self.vocab.decode_answer(outs, ocr_tokens, join_words=False)
        return [" ".join(k for k, _ in itertools.groupby(tokens)) for tokens in token_lists]


@META_TASK.register()
class TrainingMMF(OcrOpenEndedTask):
    """MMF-ported M4C: greedy-decode evaluation."""

    @torch.no_grad()
    def greedy_ids(self, device_batch) -> torch.Tensor:
        """(bs, T) int32 greedy ids, argmaxed on the device."""
        scores = self.model.greedy_decode(device_batch)["scores"]
        return scores.argmax(dim=-1).to(torch.int32)

    def evaluate_metrics(self, dataloader) -> dict:
        gens, gts = {}, {}
        for it, (batch, device_batch) in enumerate(self.device_batches(dataloader)):
            ids = self.greedy_ids(device_batch).cpu().numpy()
            answers_gen = self._decode_batch(ids, batch)
            for i, (gts_i, gen_i) in enumerate(zip(batch["answers"], answers_gen)):
                if not batch["sample_valid"][i]:
                    continue
                key = self.eval_key(batch, it, i)
                gens[key] = [gen_i]
                gts[key] = gts_i
        scores, _ = compute_scores(gts, gens)
        return scores


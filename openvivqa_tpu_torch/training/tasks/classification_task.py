"""Answer-classification task (ViVQA): the port's counterpart of
``openvivqa_tpu/training/tasks/classification_task.py``.

The loss is the NLL of the model's class log-probs with ``ignore_index =
padding_idx``, so class 0 counts for nothing (a reference quirk, kept), and
batch-padding rows count for nothing either.  The schedule is the constant
LambdaLR, whose effective rate is TRAINING.LEARNING_RATE squared (the
reference's quirk, kept).  ``start()`` trains epoch by epoch, scores the dev
split's argmax answers (TRAINING.SCORE, CIDEr by default), keeps
``last_model.pth`` and promotes it to ``best_model.pth`` when the score
improves; it stops at TRAINING.PATIENCE epochs without improvement or at
TRAINING.MAX_EPOCHS, and resumes from ``last_model.pth`` when one is present.
``get_predictions()`` answers the test split from ``best_model.pth`` and writes
``test_results.json``.  TRAINING.VERBOSE_SCORES, when set, filters the scores
that are logged and returned.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ...builders import META_TASK, build_dataset
from ...data.loader import DataLoader
from ...evaluation import compute_scores
from ...logging_utils import setup_logger
from ...parallel.multihost import gather_eval_dicts
from ...utils import tracing
from ..checkpoint import BEST_NAME, LAST_NAME, promote
from ..optim import constant_lambda
from ..profiling import EpochRecord, maybe_trace
from ..train_state import nll_loss
from .base_task import BaseTask

logger = setup_logger()


@META_TASK.register()
class ClassificationTask(BaseTask):
    def configuring_hyperparameters(self, config):
        self.score_name = config.TRAINING.SCORE
        self.patience_limit = config.TRAINING.PATIENCE
        self.max_epochs = config.TRAINING.get("MAX_EPOCHS")

    def lr_lambda(self):
        return constant_lambda(self.config.TRAINING.LEARNING_RATE)

    def load_datasets(self, config):
        self.train_dataset = build_dataset(config.JSON_PATH.TRAIN, self.vocab,
                                           config.FEATURE_DATASET)
        self.dev_dataset = build_dataset(config.JSON_PATH.DEV, self.vocab, config.FEATURE_DATASET)
        self.test_dataset = build_dataset(config.JSON_PATH.TEST, self.vocab,
                                          config.FEATURE_DATASET)

    def create_dataloaders(self, config):
        fd = config.DATASET.FEATURE_DATASET
        common = dict(batch_size=fd.BATCH_SIZE, num_workers=fd.get("WORKERS", 4),
                      seed=int(config.TRAINING.get("SEED", 42)))
        self.train_dataloader = DataLoader(self.train_dataset, shuffle=True, **common)
        self.dev_dataloader = DataLoader(self.dev_dataset, shuffle=False, **common)
        # every process predicts the whole test split, so that the primary's
        # test_results.json is complete
        self.test_dataloader = DataLoader(self.test_dataset, shuffle=False, process_shard=False,
                                          **common)

    # -- steps ---------------------------------------------------------------------
    def compute_loss(self, batch) -> torch.Tensor:
        """The training loss of one device batch, with its graph.  The model
        runs in training mode here (cuDNN's LSTM has no backward in eval mode)
        and in eval mode in `predict`; dropout follows the generator."""
        self.model.train()
        logprobs = self.model(batch, generator=self.generator)
        return nll_loss(logprobs, batch["answer"].reshape(-1), self.vocab.padding_idx,
                        weights=batch["sample_valid"])

    def class_scores(self, batch) -> torch.Tensor:
        """The model's class scores of one device batch, in eval mode."""
        return self.model(batch)

    @torch.no_grad()
    def predict(self, batch) -> np.ndarray:
        """The argmax class of each sample of one device batch, on the host."""
        with tracing.span("eval.batch"):
            self.model.eval()
            with tracing.span("eval.decode"):
                ids = self.class_scores(batch).argmax(dim=-1)
            with tracing.span("eval.to_host"):
                return ids.cpu().numpy()

    def _decode_eval(self, preds: np.ndarray, batch):
        """(ground-truth strings, predicted strings) of one batch."""
        answers_gt = self.vocab.decode_answer(batch["answer"].reshape(-1), join_word=True)
        answers_gen = self.vocab.decode_answer(preds, join_word=True)
        return answers_gt, answers_gen

    # -- loops ---------------------------------------------------------------------
    def train(self) -> List[float]:
        """One epoch; returns the per-step losses, synced once."""
        losses = []
        epoch = EpochRecord()
        with maybe_trace(self.profile_dir, enabled=self.epoch == 0):
            for _, device_batch in self.device_batches(self.train_dataloader):
                losses.append(self._train_step(device_batch))
        step_losses = torch.stack(losses).tolist() if losses else []
        record = epoch.fields()
        mean_loss = sum(step_losses) / max(len(step_losses), 1)
        logger.info("Epoch %d - training: loss=%.4f (%d it, %.1fs)",
                    self.epoch, mean_loss, len(step_losses), record["seconds"])
        self.log_metrics({"phase": "train", "loss": mean_loss, "step_losses": step_losses,
                          "iterations": len(step_losses), **record})
        return step_losses

    def evaluate_metrics(self, dataloader) -> dict:
        """Scores of the argmax answers over `dataloader` (this process's
        share), merged over the processes before scoring."""
        gens, gts = {}, {}
        with self.eval_weights():
            for it, (batch, device_batch) in enumerate(self.device_batches(dataloader)):
                answers_gt, answers_gen = self._decode_eval(self.predict(device_batch), batch)
                for i, (gt, gen) in enumerate(zip(answers_gt, answers_gen)):
                    if not batch["sample_valid"][i]:
                        continue
                    key = self.eval_key(batch, it, i)
                    gens[key] = [gen]
                    gts[key] = [gt]
        gts, gens = gather_eval_dicts(gts, gens)
        scores, _ = compute_scores(gts, gens)
        return scores

    def _filter_scores(self, scores: dict) -> dict:
        verbose = self.config.TRAINING.get("VERBOSE_SCORES")
        if verbose:
            return {k: v for k, v in scores.items() if k in verbose}
        return scores

    def start(self):
        last = os.path.join(self.checkpoint_path, LAST_NAME)
        metadata = self.load_checkpoint(last)
        if metadata is not None:
            best_val_score, patience = metadata["best_val_score"], metadata["patience"]
            self.epoch = metadata["epoch"] + 1
        else:
            best_val_score, patience = -1.0, 0

        while True:
            self.train()
            scores = self.evaluate_metrics(self.dev_dataloader)
            # the early-stop score from the unfiltered dict: VERBOSE_SCORES may omit it
            val_score = scores[self.score_name]
            scores = self._filter_scores(scores)
            logger.info("Validation scores %s", scores)
            self.log_metrics({"phase": "validation", **scores})

            best = val_score > best_val_score
            if best:
                best_val_score, patience = val_score, 0
            else:
                patience += 1
            # >= not ==: a run resumed past the limit still stops
            exit_train = patience >= self.patience_limit
            if exit_train:
                logger.info("patience reached.")
            if self.max_epochs is not None and self.epoch + 1 >= self.max_epochs:
                exit_train = True

            self.save_checkpoint({"best_val_score": best_val_score, "patience": patience})
            if best:
                promote(last, os.path.join(self.checkpoint_path, BEST_NAME))
            if exit_train:
                break
            self.epoch += 1

    def get_predictions(self):
        """Argmax answers on the test split from best_model.pth, scored and
        written to test_results.json."""
        best = os.path.join(self.checkpoint_path, BEST_NAME)
        if not os.path.isfile(best):
            raise FileNotFoundError(
                "Prediction requires a trained model: no best_model checkpoint "
                f"in {self.checkpoint_path}"
            )
        self.load_checkpoint(best)

        results, overall_gens, overall_gts = [], {}, {}
        with self.eval_weights():
            test_batches = [(batch, self.predict(device_batch))
                            for batch, device_batch in self.device_batches(self.test_dataloader)]
        for it, (batch, preds) in enumerate(test_batches):
            answers_gt, answers_gen = self._decode_eval(preds, batch)
            valid = np.asarray(batch["sample_valid"])
            gens, gts = {}, {}
            for i, (gt, gen) in enumerate(zip(answers_gt, answers_gen)):
                if not valid[i]:
                    continue
                key = f"{it}_{i}"
                gens[key] = gen
                gts[key] = gt
                overall_gens[key] = [gen]
                overall_gts[key] = [gt]
            results.append({
                "id": [int(x) for x in np.asarray(batch["question_id"])[valid]],
                "filename": [f for f, v in zip(batch["filename"], valid) if v],
                "gens": gens,
                "gts": gts,
            })

        scores, _ = compute_scores(overall_gts, overall_gens)
        scores = self._filter_scores(scores)
        logger.info("Evaluation scores on test: %s", scores)
        self.dump_json("test_results.json", {"results": results, **scores})
        return scores

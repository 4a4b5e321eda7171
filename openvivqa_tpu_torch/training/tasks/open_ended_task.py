"""Open-ended (generative) VQA task: XE training on teacher-forced log-probs,
beam-searched evaluation and test predictions.  The port's counterpart of
``openvivqa_tpu/training/tasks/open_ended_task.py``.

An epoch runs the train step over the shuffled train split, keeps each step's
loss on the device and syncs once at the epoch's end.  ``start()`` trains epoch
by epoch, evaluates the dev split with beam search (TRAINING.EVALUATING_BEAM_SIZE
beams over batches of DICT_DATASET.BATCH_SIZE // beams samples), keeps
``last_model.pth`` and promotes it to ``best_model.pth`` when the score
improves; it stops at TRAINING.PATIENCE epochs without improvement or at
TRAINING.MAX_EPOCHS, and resumes from ``last_model.pth`` when one is present.

With TRAINING.USE_SCST, patience running out switches the run to
self-critical sequence training (``train_scst``, the protocol the reference
leaves commented out): best_model.pth is reloaded, Adam starts afresh at the
constant TRAINING.RL_LEARNING_RATE, and each epoch goes over the train split
as one sample per question, in batches of DICT_DATASET.BATCH_SIZE //
TRAINING_BEAM_SIZE.  A batch draws k = TRAINING_BEAM_SIZE beams per sample in
eval mode, rewards each with CIDEr against the sample's answers (document
frequencies of the train split's answers, ``train_cider``), takes the reward
less its mean over the sample's beams as the advantage, re-runs the sampled
sequences teacher-forced on the k-repeated batch and steps Adam on
mean(-advantage * sum of the tokens' log-probs / L).  The re-run is the JAX
package's deterministic but differentiable call: training mode (cuDNN's LSTM
has a backward only there) without a generator, so no dropout; every attention
of the SCST-capable models runs there through the packed kernel's autograd
function or the flat attention's, which carry the gradient.  ``use_rl`` is kept
in the checkpoint's metadata; a resumed RL run keeps Adam's moments and step
and only takes the RL rate.  ``TrainingSAAATask`` is the same task at the
constant LambdaLR schedule.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import List

import numpy as np
import torch

from ...builders import META_TASK, build_dataset
from ...data.loader import DataLoader
from ...evaluation import Cider, compute_scores
from ...logging_utils import setup_logger
from ...parallel.multihost import gather_eval_dicts
from ...utils import tracing
from ..checkpoint import BEST_NAME, LAST_NAME, promote
from ..decode import generate
from ..optim import constant_lambda, make_optimizer
from ..profiling import EpochRecord, maybe_trace
from ..train_state import nll_loss
from .base_task import BaseTask

logger = setup_logger()


def _pad_tables(ocr_tokens, n_rows):
    """Extend per-sample OCR tables to the padded batch size (padding rows
    reuse the last table; sample_valid drops them)."""
    tables = list(ocr_tokens)
    if tables and len(tables) < n_rows:
        tables += [tables[-1]] * (n_rows - len(tables))
    return tables


@META_TASK.register()
class OpenEndedTask(BaseTask):
    def configuring_hyperparameters(self, config):
        self.score_name = config.TRAINING.SCORE
        self.evaluating_beam_size = config.TRAINING.EVALUATING_BEAM_SIZE
        self.training_beam_size = config.TRAINING.get("TRAINING_BEAM_SIZE")
        self.rl_learning_rate = config.TRAINING.get("RL_LEARNING_RATE", 5e-6)
        self.patience_limit = config.TRAINING.PATIENCE
        self.max_epochs = config.TRAINING.get("MAX_EPOCHS")
        # the SCST reward's document frequencies: the train split's answers
        self.train_cider = Cider(
            {f"{i}": [" ".join(a)] for i, a in enumerate(self.train_dataset.answers)})

    def load_datasets(self, config):
        self.train_dataset = build_dataset(config.JSON_PATH.TRAIN, self.vocab,
                                           config.FEATURE_DATASET)
        self.train_dict_dataset = build_dataset(config.JSON_PATH.TRAIN, self.vocab,
                                                config.DICT_DATASET)
        self.dev_dict_dataset = build_dataset(config.JSON_PATH.DEV, self.vocab,
                                              config.DICT_DATASET)
        self.test_dict_dataset = build_dataset(config.JSON_PATH.TEST, self.vocab,
                                               config.DICT_DATASET)

    def create_dataloaders(self, config):
        fd = config.DATASET.FEATURE_DATASET
        dd = config.DATASET.DICT_DATASET
        seed = int(config.TRAINING.get("SEED", 42))
        self.train_dataloader = DataLoader(
            self.train_dataset, batch_size=fd.BATCH_SIZE, shuffle=True,
            num_workers=fd.get("WORKERS", 4), seed=seed,
        )
        eval_bs = max(1, dd.BATCH_SIZE // config.TRAINING.EVALUATING_BEAM_SIZE)
        workers = dd.get("WORKERS", 4)
        # SCST's beams: DICT_DATASET.BATCH_SIZE rows a batch, as in the eval
        train_beam = config.TRAINING.get("TRAINING_BEAM_SIZE")
        self.train_dict_dataloader = None if not train_beam else DataLoader(
            self.train_dict_dataset, batch_size=max(1, dd.BATCH_SIZE // train_beam),
            shuffle=True, num_workers=workers, seed=seed,
        )
        self.dev_dict_dataloader = DataLoader(
            self.dev_dict_dataset, batch_size=eval_bs, shuffle=False, num_workers=workers,
            seed=seed,
        )
        # every process predicts the whole test split (a complete prediction file)
        self.test_dict_dataloader = DataLoader(
            self.test_dict_dataset, batch_size=eval_bs, shuffle=False, num_workers=workers,
            seed=seed, process_shard=False,
        )

    def compute_loss(self, batch) -> torch.Tensor:
        """The training loss of one device batch, with its graph: the NLL of
        the teacher-forced log-probs against the shifted answers, weighted by
        sample_valid so that batch-padding rows count for nothing.  The model
        runs in training mode here (cuDNN's LSTM, IterativeSAAA's, has no
        backward in eval mode) and in eval mode in `generate_answers`; dropout
        follows the generator."""
        self.model.train()
        logprobs = self.model(batch, generator=self.generator)
        # a copy id no output reads (OcrVocab's, under a fixed-vocab decoder) is <unk>
        targets = batch["shifted_right_answer_tokens"]
        targets = torch.where(targets < logprobs.shape[-1], targets, self.vocab.unk_idx)
        weights = batch["sample_valid"][:, None].expand(targets.shape)
        return nll_loss(logprobs.reshape(-1, logprobs.shape[-1]), targets.reshape(-1),
                        self.vocab.padding_idx, weights=weights.reshape(-1))

    def _decode_batch(self, outs: np.ndarray, batch=None) -> list:
        """(bs, T) ids, or (n, k, T) beam samples, -> answer strings,
        consecutive repeats merged.  When the batch carries each sample's OCR
        tokens (an OCR vocab's datasets), the ids decode against those tables:
        row r of the (n * k, T) flattening belongs to sample r // k, so each
        sample's table is repeated k times."""
        flat = outs.reshape(-1, self.vocab.max_answer_length)
        if batch is None or "ocr_tokens" not in batch:
            token_lists = self.vocab.decode_answer(flat, join_words=False)
        else:
            n_samples = outs.shape[0] if outs.ndim == 3 else flat.shape[0]
            reps = max(flat.shape[0] // max(n_samples, 1), 1)
            tables = [t for t in list(batch["ocr_tokens"])[:n_samples] for _ in range(reps)]
            token_lists = self.vocab.decode_answer(flat, _pad_tables(tables, flat.shape[0]),
                                                   join_words=False)
        return [" ".join(k for k, _ in itertools.groupby(tokens)) for tokens in token_lists]

    def answer_ids(self, device_batch) -> torch.Tensor:
        """The answers' ids of one device batch, on the device: beam-searched."""
        self.model.eval()
        return generate(self.model, device_batch, self.evaluating_beam_size)[0]

    def generate_answers(self, batch, device_batch) -> list:
        """The answer strings of one batch; only (bs, T) ids cross to the host."""
        with tracing.span("eval.batch"):
            with tracing.span("eval.decode"):
                ids = self.answer_ids(device_batch)
            with tracing.span("eval.to_host"):
                ids = ids.cpu().numpy()
            with tracing.span("eval.strings"):
                return self._decode_batch(ids, batch)

    def evaluate_metrics(self, dataloader) -> dict:
        """Scores of the generated answers over `dataloader` (this process's
        share), merged over the processes before scoring."""
        gens, gts = {}, {}
        with self.eval_weights():
            for it, (batch, device_batch) in enumerate(self.device_batches(dataloader)):
                answers_gen = self.generate_answers(batch, device_batch)
                for i, (gts_i, gen_i) in enumerate(zip(batch["answers"], answers_gen)):
                    if not batch["sample_valid"][i]:
                        continue
                    key = self.eval_key(batch, it, i)
                    gens[key] = [gen_i]
                    gts[key] = gts_i
        gts, gens = gather_eval_dicts(gts, gens)
        scores, _ = compute_scores(gts, gens)
        return scores

    def train(self) -> List[float]:
        """One XE epoch; returns the per-step losses, synced once."""
        losses = []
        epoch = EpochRecord()
        with maybe_trace(self.profile_dir, enabled=self.epoch == 0):
            for _, device_batch in self.device_batches(self.train_dataloader):
                losses.append(self._train_step(device_batch))
        step_losses = torch.stack(losses).tolist() if losses else []
        record = epoch.fields()
        mean_loss = sum(step_losses) / max(len(step_losses), 1)
        logger.info("Epoch %d - XE training: loss=%.4f (%d it, %.1fs)",
                    self.epoch, mean_loss, len(step_losses), record["seconds"])
        self.log_metrics({"phase": "train", "loss": mean_loss, "step_losses": step_losses,
                          "iterations": len(step_losses), **record})
        return step_losses

    # -- SCST --------------------------------------------------------------------
    def scst_samples(self, device_batch) -> torch.Tensor:
        """SCST's beam draw: (n, k, L) ids, the k = TRAINING_BEAM_SIZE best
        beams of each sample, in eval mode."""
        self.model.eval()
        with self.eval_weights():
            outs, _ = generate(self.model, device_batch, self.training_beam_size,
                               out_size=self.training_beam_size)
        return outs

    def scst_loss(self, batch, advantages: torch.Tensor, outs: torch.Tensor) -> torch.Tensor:
        """mean(-advantage * sequence log-prob) of the (n, k, L) samples `outs`:
        each re-run teacher-forced (BOS, then the sample but its last token) on
        the k-repeated batch, deterministic and with its graph; a sequence's
        log-prob is the sum of its non-pad tokens' over the static L, as the JAX
        package divides."""
        self.model.train()
        n, k, length = outs.shape
        flat = outs.reshape(n * k, length).long()
        repeated = {key: value.repeat_interleave(k, dim=0) for key, value in batch.items()}
        encoder_features, encoder_bias = self.model.encode(repeated)
        bos = torch.full_like(flat[:, :1], self.vocab.bos_idx)
        logprobs = self.model.decode_teacher_forced(torch.cat([bos, flat[:, :-1]], dim=1),
                                                    encoder_features, encoder_bias)
        token_lp = logprobs.gather(-1, flat[..., None])[..., 0]
        mask = (flat != self.vocab.padding_idx).to(token_lp.dtype)
        seq_lp = (token_lp * mask).sum(-1) / float(length)
        return torch.mean(-seq_lp.reshape(n, k) * advantages)

    def scst_rewards(self, batch, outs: np.ndarray) -> np.ndarray:
        """(n, k) CIDEr rewards of the samples against their answers; the
        batch-padding rows get 0."""
        beam = outs.shape[1]
        n_real = int(np.asarray(batch["sample_valid"]).sum())
        reward = np.zeros(outs.shape[:2], np.float32)
        if n_real:
            answers_gen = self._decode_batch(outs[:n_real], batch)
            answers_gt = list(itertools.chain(*([a] * beam for a in batch["answers"][:n_real])))
            gens = {f"{i}": [g] for i, g in enumerate(answers_gen)}
            gts = {f"{i}": gt for i, gt in enumerate(answers_gt)}
            reward[:n_real] = self.train_cider.compute_score(gts, gens)[1].astype(
                np.float32).reshape(n_real, beam)
        return reward

    def train_scst(self):
        """One SCST epoch over the train split; returns (mean loss, mean
        reward of the real rows) over its batches."""
        if self.train_dict_dataloader is None:
            raise ValueError("SCST needs TRAINING.TRAINING_BEAM_SIZE")
        losses, rewards = [], []
        start = time.time()
        for batch, device_batch in self.device_batches(self.train_dict_dataloader):
            outs = self.scst_samples(device_batch)
            reward = self.scst_rewards(batch, outs.cpu().numpy())
            valid = np.asarray(batch["sample_valid"])
            advantages = (reward - reward.mean(-1, keepdims=True)) * valid[:, None]
            self.optimizer.zero_grad(set_to_none=True)
            # through train_forward, so that DDP averages the re-run's gradients
            loss = self.train_forward(self.scst_loss, device_batch,
                                      torch.from_numpy(advantages).to(self.device), outs)
            loss.backward()
            self.optimizer.step()
            self.scheduler.step()
            losses.append(float(loss.detach()))
            # real rows only: the zeroed padding rows would understate the reward
            rewards.append(float(reward[valid].mean()) if valid.any() else 0.0)
        mean_loss = sum(losses) / max(len(losses), 1)
        mean_reward = sum(rewards) / max(len(rewards), 1)
        elapsed = time.time() - start
        logger.info("Epoch %d - SCST: loss=%.4f reward=%.4f (%d it, %.1fs)",
                    self.epoch, mean_loss, mean_reward, len(losses), elapsed)
        self.log_metrics({"phase": "scst", "loss": mean_loss, "reward": mean_reward,
                          "step_losses": losses, "step_rewards": rewards,
                          "iterations": len(losses), "seconds": elapsed})
        return mean_loss, mean_reward

    def _switch_to_scst(self, resume: bool = False):
        """Adam at the constant RL_LEARNING_RATE.  The XE -> RL transition
        reloads best_model.pth and starts Adam afresh; resuming a run
        checkpointed in the RL phase keeps the restored weights, Adam's moments
        and step, and the schedule's count, and only swaps the rate (the
        loaded schedule's own would scale it by the XE lambda)."""
        if not resume:
            best = os.path.join(self.checkpoint_path, BEST_NAME)
            if os.path.isfile(best):
                self.load_checkpoint(best)
            self.optimizer, self.scheduler = make_optimizer(
                self.model.parameters(), self.rl_learning_rate, constant_lambda(1.0))
        else:
            groups = self.optimizer.param_groups
            for group in groups:
                group["lr"] = group["initial_lr"] = self.rl_learning_rate
            self.scheduler.base_lrs = [self.rl_learning_rate] * len(groups)
            self.scheduler.lr_lambdas = [constant_lambda(1.0)] * len(groups)
        logger.info("Switching to SCST (lr=%s)%s", self.rl_learning_rate,
                    " [resume]" if resume else "")

    def start(self):
        last = os.path.join(self.checkpoint_path, LAST_NAME)
        metadata = self.load_checkpoint(last)
        if metadata is not None:
            best_val_score, patience = metadata["best_val_score"], metadata["patience"]
            use_rl = metadata.get("use_rl", False)
            self.epoch = metadata["epoch"] + 1
        else:
            best_val_score, patience, use_rl = -1.0, 0, False
        use_scst = bool(self.config.TRAINING.get("USE_SCST", False))
        if use_rl:
            self._switch_to_scst(resume=True)

        while True:
            if use_rl:
                self.train_scst()
            else:
                self.train()
            scores = self.evaluate_metrics(self.dev_dict_dataloader)
            logger.info("Validation scores %s", scores)
            self.log_metrics({"phase": "validation", **scores})
            val_score = scores[self.score_name]

            best = val_score > best_val_score
            if best:
                best_val_score, patience = val_score, 0
            else:
                patience += 1
            exit_train = False
            # >= not ==: a run resumed past the limit still stops
            if patience >= self.patience_limit:
                if use_scst and not use_rl:
                    use_rl, patience = True, 0
                    self._switch_to_scst()
                else:
                    logger.info("patience reached.")
                    exit_train = True
            if self.max_epochs is not None and self.epoch + 1 >= self.max_epochs:
                exit_train = True

            self.save_checkpoint({"best_val_score": best_val_score, "patience": patience,
                                  "use_rl": use_rl})
            if best:
                promote(last, os.path.join(self.checkpoint_path, BEST_NAME))
            if exit_train:
                break
            self.epoch += 1

    def _predict_split(self, dataloader, out_name: str, key=lambda batch, it, i: f"{it}_{i}"):
        """Beam-searched answers of one split, scored and written to
        <checkpoint dir>/<out_name>, each sample under key(batch, it, i)."""
        results, overall_gens, overall_gts = [], {}, {}
        with self.eval_weights():
            answered = [(batch, self.generate_answers(batch, device_batch))
                        for batch, device_batch in self.device_batches(dataloader)]
        for it, (batch, answers_gen) in enumerate(answered):
            valid = np.asarray(batch["sample_valid"])
            gens, gts = {}, {}
            for i, (gts_i, gen_i) in enumerate(zip(batch["answers"], answers_gen)):
                if not valid[i]:
                    continue
                name = key(batch, it, i)
                gens[name] = gen_i
                gts[name] = gts_i
                overall_gens[name] = [gen_i]
                overall_gts[name] = gts_i
            results.append({
                "id": [int(x) for x in np.asarray(batch["question_id"])[valid]],
                "image_id": [int(x) for x in np.asarray(batch["image_id"])[valid]],
                "filename": [f for f, v in zip(batch["filename"], valid) if v],
                "gens": gens,
                "gts": gts,
            })

        scores, _ = compute_scores(overall_gts, overall_gens)
        logger.info("Evaluation scores on %s: %s", out_name, scores)
        self.dump_json(out_name, {"results": results, **scores})
        return scores

    def load_best_model(self) -> None:
        best = os.path.join(self.checkpoint_path, BEST_NAME)
        if not os.path.isfile(best):
            raise FileNotFoundError(
                "Prediction requires a trained model: no best_model checkpoint "
                f"in {self.checkpoint_path}"
            )
        self.load_checkpoint(best)

    def get_predictions(self):
        """Beam-searched predictions on the test split from best_model.pth,
        scored and written to test_results.json."""
        self.load_best_model()
        return self._predict_split(self.test_dict_dataloader, "test_results.json")


@META_TASK.register()
class TrainingSAAATask(OpenEndedTask):
    """OpenEndedTask with the constant LambdaLR schedule."""

    def lr_lambda(self):
        return constant_lambda(self.config.TRAINING.LEARNING_RATE)

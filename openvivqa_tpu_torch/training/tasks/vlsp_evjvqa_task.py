"""The EVJVQA contest task (VLSP 2022): four splits, train, dev, public test and
private test, with a prediction file for each test split.

Counterpart of ``openvivqa_tpu/training/tasks/vlsp_evjvqa_task.py``: the
OpenEndedTask protocol (XE training, beam-searched dev eval, checkpoints) over
the four splits: the train split as teacher-forcing samples, every split as
one sample per question.  The dictionary loaders run at DICT_DATASET.BATCH_SIZE
// beam samples (TRAINING_BEAM_SIZE for the train split, which SCST reads;
EVALUATING_BEAM_SIZE for the others), so a beam-searched batch holds
BATCH_SIZE rows.  The JAX package's per-answer datasets of the dev and test
splits have no reader and are not built.  ``get_predictions()``
loads ``best_model.pth`` and writes ``public_test_results.json`` and
``private_test_results.json``; a split without a JSON_PATH is skipped.
"""

from __future__ import annotations

from ...builders import META_TASK, build_dataset
from ...data.loader import DataLoader
from .open_ended_task import OpenEndedTask


@META_TASK.register()
class VlspEvjVqaTask(OpenEndedTask):
    def load_datasets(self, config):
        def build(split, dataset_config):
            path = config.JSON_PATH.get(split)
            return build_dataset(path, self.vocab, dataset_config) if path else None

        self.train_dataset = build("TRAIN", config.FEATURE_DATASET)
        self.train_dict_dataset = build("TRAIN", config.DICT_DATASET)
        self.dev_dict_dataset = build("DEV", config.DICT_DATASET)
        self.public_test_dict_dataset = build("PUBLIC_TEST", config.DICT_DATASET)
        self.private_test_dict_dataset = build("PRIVATE_TEST", config.DICT_DATASET)

    def create_dataloaders(self, config):
        fd = config.DATASET.FEATURE_DATASET
        dd = config.DATASET.DICT_DATASET
        seed = int(config.TRAINING.get("SEED", 42))
        workers = fd.get("WORKERS", 4)

        def loader(dataset, batch_size, shuffle, process_shard=True):
            if dataset is None:
                return None
            return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                              num_workers=workers, seed=seed, process_shard=process_shard)

        self.train_dataloader = loader(self.train_dataset, fd.BATCH_SIZE, True)
        train_dict_bs = max(1, dd.BATCH_SIZE // config.TRAINING.TRAINING_BEAM_SIZE)
        eval_dict_bs = max(1, dd.BATCH_SIZE // config.TRAINING.EVALUATING_BEAM_SIZE)
        self.train_dict_dataloader = loader(self.train_dict_dataset, train_dict_bs, True)
        self.dev_dict_dataloader = loader(self.dev_dict_dataset, eval_dict_bs, False)
        # every process predicts the whole test splits (complete prediction files)
        self.public_test_dict_dataloader = loader(self.public_test_dict_dataset, eval_dict_bs,
                                                  False, process_shard=False)
        self.private_test_dict_dataloader = loader(self.private_test_dict_dataset,
                                                   eval_dict_bs, False, process_shard=False)

    def get_predictions(self):
        """Scores by test split, from best_model.pth; each sample keyed by its
        question id."""
        self.load_best_model()
        scores = {}
        for split, loader in (("public_test", self.public_test_dict_dataloader),
                              ("private_test", self.private_test_dict_dataloader)):
            if loader is not None:
                scores[split] = self._predict_split(loader, f"{split}_results.json",
                                                    key=self.eval_key)
        return scores

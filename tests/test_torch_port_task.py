"""The port's TrainingMMF eval task end to end on the synthetic data, on the CPU
(each kernel's plain version), in both decode modes; and the port's promise
that it runs without JAX."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from openvivqa_tpu_torch.config import ConfigNode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32
K = 8


def _config(paths, checkpoint_path, decoding_mode=None):
    dataset_common = {
        "MAX_SCENE_TEXT": K,
        "SCENE_TEXT_THRESHOLD": 0.3,
        "WORD_EMBEDDING": None,
        "FEATURE_PATH": {"FEATURES": paths["features"], "SCENE_TEXT": paths["scene_text"]},
    }
    jp = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]}
    model = {
        "NAME": "mmf_m4c_port_test",
        "ARCHITECTURE": "MMF_M4C",
        "D_MODEL": D,
        "MMT": {"HIDDEN_SIZE": D, "NUM_HIDDEN_LAYERS": 2, "NUM_ATTENTION_HEADS": 2},
        "TEXT_BERT": {"HIDDEN_SIZE": D, "NUM_HIDDEN_LAYERS": 1, "LOAD_PRETRAINED": False},
        "OBJECT_EMBEDDING": {"D_FEATURE": 1024, "DROPOUT": 0.1},
        "OCR_EMBEDDING": {"D_FEATURE": 300 + 256 + 256, "DROPOUT": 0.1},
        "OCR_PTR_NET": {"HIDDEN_SIZE": D, "QUERY_KEY_SIZE": D},
    }
    if decoding_mode:
        model["DECODING_MODE"] = decoding_mode
    return ConfigNode({
        "TASK": "TrainingMMF",
        "DATASET": {
            "FEATURE_DATASET": dict(dataset_common, TYPE="OcrFeatureDataset", BATCH_SIZE=8,
                                    WORKERS=2),
            "DICT_DATASET": dict(dataset_common, TYPE="OcrDictionaryDataset", BATCH_SIZE=8,
                                 WORKERS=2),
            "VOCAB": {
                "TYPE": "OcrVocab", "TOKENIZER": None, "MIN_FREQ": 1, "WORD_EMBEDDING": None,
                "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>", "EOS_TOKEN": "<eos>",
                "UNK_TOKEN": "<unk>", "IMG_TOKEN": "<img>", "FEAT_TOKEN": "<feat>",
                "BOX_TOKEN": "<box>", "OCR_TOKEN": "<ocr>", "OCR_DET_TOKEN": "<ocr_det>",
                "OCR_REC_TOKEN": "<ocr_rec>", "QUESTION_TOKEN": "<question>",
                "ANSWER_TOKEN": "<answer>", "JSON_PATH": jp,
            },
            "JSON_PATH": jp,
        },
        "TRAINING": {
            "CHECKPOINT_PATH": str(checkpoint_path), "LEARNING_RATE": 1.0, "WARMUP": 100,
            "EVALUATING_BEAM_SIZE": 1, "SCORE": "CIDEr", "PATIENCE": 2, "MAX_EPOCHS": 1,
            "SEED": 5,
        },
        "MODEL": model,
    })


@pytest.mark.parametrize("decoding_mode", [None, "incremental"])
def test_evaluate_metrics_end_to_end(synthetic_data, tmp_path, decoding_mode):
    from openvivqa_tpu_torch.builders import build_task, populate

    populate()
    task = build_task(_config(synthetic_data, tmp_path, decoding_mode), "cpu")
    assert next(task.model.parameters()).device.type == "cpu"
    scores = task.evaluate_metrics(task.dev_dict_dataloader)
    assert "CIDEr" in scores
    assert scores["CIDEr"] >= 0.0

    host, batch = next(task.device_batches(task.dev_dict_dataloader))
    ids = task.greedy_ids(batch)
    assert ids.shape == (8, task.vocab.max_answer_length) and ids.dtype == torch.int32
    assert len(task._decode_batch(ids.numpy(), host)) == 8


def test_training_entry_points_wait_for_the_training_slice(synthetic_data, tmp_path):
    """Predictions wait for a trained best checkpoint: get_predictions raises
    until start() has written best_model.pth, then reads it."""
    from openvivqa_tpu_torch.builders import build_task, populate

    populate()
    task = build_task(_config(synthetic_data, tmp_path), "cpu")
    with pytest.raises(FileNotFoundError, match="best_model"):
        task.get_predictions()
    task.start()
    assert "CIDEr" in task.get_predictions()


def test_port_runs_without_jax(synthetic_data, tmp_path):
    """populate(), building the task, a train step and the eval task import
    neither JAX nor anything of the JAX package."""
    script = textwrap.dedent(
        """
        import json, sys
        from openvivqa_tpu_torch.config import ConfigNode
        from openvivqa_tpu_torch.builders import build_task, populate
        populate()
        task = build_task(ConfigNode(json.loads(sys.argv[1])), "cpu")
        _, batch = next(task.device_batches(task.train_dataloader))
        task._train_step(batch)
        scores = task.evaluate_metrics(task.dev_dict_dataloader)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "flax", "optax", "openvivqa_tpu"))
        print(json.dumps({"cider": float(scores["CIDEr"]), "leaked": leaked}))
        """
    )
    config = _config(synthetic_data, tmp_path, "incremental").to_dict()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-c", script, json.dumps(config)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["leaked"] == []
    assert result["cider"] >= 0.0

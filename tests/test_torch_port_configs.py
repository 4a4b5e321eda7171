"""Every YAML under configs/ builds in the port: its vocab, its train dataset,
one collated batch, its dictionary dataset where it has one, its task's class,
and its model at the config's full widths on the ``meta`` device (shapes
without storage, as the JAX package's tests/test_all_reference_configs.py
traces its configs with ``jax.eval_shape``).  Data paths point at the port's
synthetic sets: an EVJVQA-shaped one (raw images, the VinVL-shaped store and,
for vit_mbert_generation.yaml, the ViT-shaped store) for the EVJVQA configs,
the OpenViVQA-shaped one (regions, grids, scene text, images) for the rest.
Word vectors and pretrained weights are not in the repository and are switched
off."""

import glob
import os

import pytest
import torch

from openvivqa_tpu_torch import builders
from openvivqa_tpu_torch.config import get_config
from openvivqa_tpu_torch.data import synthetic
from openvivqa_tpu_torch.utils.instance import collate

builders.populate()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("config_data")
    main = synthetic.generate_synthetic_dataset(str(root / "main"), n_images=6, seed=0)
    evjvqa = synthetic.generate_evjvqa_dataset(str(root / "evjvqa"), n_images=6, seed=0)
    evjvqa["vit"] = str(root / "evjvqa" / "vit")
    synthetic.write_vit_features(evjvqa["vit"], 6, seed=0)
    return {"main": main, "evjvqa": evjvqa}


def _on_synthetic_data(config, data):
    """The config with every data path on the synthetic sets, and no word
    vectors or pretrained weights."""
    dataset = config.DATASET
    sections = [key for key in ("FEATURE_DATASET", "DICT_DATASET") if dataset.get(key)]
    features = str((dataset.get(sections[0]) if sections else dataset).FEATURE_PATH.get(
        "FEATURES") or "") + str(dataset.FEATURE_PATH.get("IMAGE") if dataset.get(
            "FEATURE_PATH") else "")
    evjvqa = "EVJVQA" in features or "PUBLIC_TEST" in dataset.JSON_PATH
    paths = data["evjvqa" if evjvqa else "main"]
    store = paths["vit"] if features.rstrip("/").endswith("vit") else paths["features"]
    feature_path = {"FEATURES": store, "IMAGE": paths["images"],
                    "SCENE_TEXT": paths.get("scene_text")}
    test = paths.get("test", paths.get("public_test"))
    json_paths = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": test,
                  "PUBLIC_TEST": test, "PRIVATE_TEST": paths.get("private_test", test)}
    override = {"JSON_PATH": {key: json_paths[key] for key in set(dataset.JSON_PATH) | {
        "TRAIN", "DEV", "TEST"}},
        "VOCAB": {"WORD_EMBEDDING": None, "JSON_PATH": {
            "TRAIN": paths["train"], "DEV": paths["dev"], "TEST": test}}}
    for key in sections:
        override[key] = {"FEATURE_PATH": feature_path, "WORD_EMBEDDING": None}
    if dataset.get("FEATURE_PATH") is not None:
        override["FEATURE_PATH"] = feature_path
    model = {"TEXT_BERT": {"LOAD_PRETRAINED": False}} if config.MODEL.get("TEXT_BERT") else {}
    return config.merged({"DATASET": override, "MODEL": model})


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_builds_in_the_port(path, data):
    config = _on_synthetic_data(get_config(path), data)
    dataset_config = config.DATASET
    vocab = builders.build_vocab(dataset_config.VOCAB)
    feature_section = dataset_config.get("FEATURE_DATASET") or dataset_config
    dataset = builders.build_dataset(dataset_config.JSON_PATH.TRAIN, vocab, feature_section)
    assert len(dataset) > 0
    batch = collate([dataset[i] for i in range(min(2, len(dataset)))], batch_pad_to=2)
    assert batch["sample_valid"].shape == (2,)
    if dataset_config.get("DICT_DATASET") is not None:
        dict_dataset = builders.build_dataset(dataset_config.JSON_PATH.DEV, vocab,
                                              dataset_config.DICT_DATASET)
        assert len(dict_dataset) > 0 and dict_dataset[0]
    assert builders.META_TASK.get(config.TASK) is not None
    with torch.device("meta"):
        model = builders.build_model(config.MODEL, vocab, dataset[0])
    # configs/iterative_m4c.yaml names M4C with the IterativeM4C schema, as the JAX package reads it
    want = "IterativeM4C" if config.MODEL.get("OCR_DET_EMBEDDING") else config.MODEL.ARCHITECTURE
    assert type(model).__name__ == want
    params = list(model.parameters())
    assert params and all(p.is_meta for p in params)
    assert sum(p.numel() for p in params) > 0

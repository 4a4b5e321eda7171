"""A cell added by files alone runs through the shared harness: a
configuration with no OCR key (``configs/saaa.yaml``'s SAAA on a
FeatureClassificationDataset), its own generator, reference, FLOP count,
limits and a per-layer metric's reader, under the existing train_xe kind and
the existing readers of split quantities, on the CPU at small widths.  Its
stand-in reference reads nothing the program computes, so the run is judged
not correct; what is tested is that main.py, program.py and files.py take the
cell as they find it."""

import json
import shutil
import subprocess
import sys

import portbench_small as small
import yaml

GENERATOR = '''
"""Region features and classification annotations from a seed."""
import json
import os

import numpy as np

WORDS = ["con", "meo", "cho", "mau", "gi", "do", "xanh", "vang"]


def generate(root, mix, seed):
    rng = np.random.default_rng(seed)
    feat_dir, ann_dir = os.path.join(root, "features"), os.path.join(root, "annotations")
    os.makedirs(feat_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    for image_id in range(mix["images"]):
        np.save(os.path.join(feat_dir, f"{image_id}.npy"), {
            "region_features": rng.standard_normal((mix["regions"], mix["d_region"]),
                                                   np.float32)}, allow_pickle=True)
    anns = [{"id": k, "image_id": k % mix["images"],
             "question": " ".join(rng.choice(WORDS, 4)) + " ?",
             "answers": [str(rng.choice(WORDS))]} for k in range(3 * mix["images"])]
    images = [{"id": i, "filename": f"{i}.jpg"} for i in range(mix["images"])]
    paths = {"features": feat_dir}
    for split in ("train", "dev", "test"):
        paths[split] = os.path.join(ann_dir, f"{split}.json")
        with open(paths[split], "w") as handle:
            json.dump({"images": images, "annotations": anns}, handle)
    return paths


def config_keys(paths):
    keys = {"DATASET.FEATURE_DATASET.FEATURE_PATH.FEATURES": paths["features"]}
    for split in ("TRAIN", "DEV", "TEST"):
        keys[f"DATASET.JSON_PATH.{split}"] = paths[split.lower()]
        keys[f"DATASET.VOCAB.JSON_PATH.{split}"] = paths[split.lower()]
    return keys
'''

REFERENCE = '''
"""A stand-in reference: readings of fixed values over the weights' names."""
import torch


class Split:
    def train_batch(self, host, device):
        return {"rows": torch.as_tensor(host["sample_valid"])}, 0


def read_split(config, paths):
    return Split()


def shapes(config, traffic, split):
    return {"regions": traffic["regions"]}


def train_readings(config, weights, batches, seed, precision="fp32", fault=None):
    return {"loss": [1.0] * len(batches), "grad_norms": {name: 1.0 for name in weights},
            "change_norms": {name: 1.0 for name in weights}}


def step_scores(config, weights, batch, prev_inds, precision="fp32"):
    raise NotImplementedError
'''

WORK = '''
def flops(config, shapes):
    width = config["MODEL.D_MODEL"]
    forward = 2.0 * shapes["regions"] * config["MODEL.VISION_PROCESSOR.D_FEATURE"] * width
    return {"forward": forward, "train": 3 * forward, "eval": forward}
'''

RUN = '''
import argparse, json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from portbench import env, main
env.prepare()
args = argparse.Namespace(workload="saaa_small.train_xe_features", seed=2**31 + 7,
                          seconds=1.0, trace=int(sys.argv[3]))
print(json.dumps(main.execute(args, time.time(), device="cpu"), default=float))
'''


def flat(node, prefix=""):
    out = {}
    for key, value in node.items():
        if isinstance(value, dict):
            out.update(flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


def new_cell(tmp_path):
    """The benchmark copied under `tmp_path`, with the new cell's files and
    entries added and nothing else changed."""
    shutil.copytree(small.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    config = flat(yaml.safe_load((small.ROOT / "configs" / "saaa.yaml").read_text()))
    assert not [key for key in config if "SCENE_TEXT" in key and config[key] is not None]
    config.update({key: 32 for key in config if key.endswith(("D_MODEL", "D_LANGUAGE",
                                                              "D_VISION"))})
    config.update({"MODEL.TEXT_PROCESSOR.D_EMBEDDING": 16, "MODEL.VISION_PROCESSOR.D_FEATURE": 24,
                   "DATASET.FEATURE_DATASET.BATCH_SIZE": 4, "DATASET.FEATURE_DATASET.WORKERS": 1,
                   "MODEL.DEVICE": "cpu"})
    (bench / "configs" / "saaa_small.json").write_text(json.dumps(config))
    (bench / "data" / "vqa_features.py").write_text(GENERATOR)
    (bench / "reference" / "saaa_small.py").write_text(REFERENCE)
    (bench / "metrics" / "steps.features.py").write_text(
        "def read(record, metric):\n    return record['window'].get('steps')\n")
    (bench / "work" / "models" / "saaa_small.py").write_text(WORK)
    (bench / "traffic" / "train_xe_features.json").write_text(json.dumps({
        "kind": "train_xe", "generator": "vqa_features", "images": 8, "regions": 5,
        "d_region": 24, "checked_steps": 2, "traced_steps": 2}))
    (bench / "limits" / "saaa_small.train_xe_features.json").write_text(json.dumps({
        "loss_gap": 1e-5, "input_mismatches": 0}))
    spec = json.loads((small.ROOT / "BENCHMARK.json").read_text())
    cell = "saaa_small.train_xe_features"
    spec["configs"].append({"name": "saaa_small", "source": "configs/saaa.yaml",
                            "file": "benchmark/configs/saaa_small.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": cell, "config": "saaa_small",
                              "traffic": "train_xe_features", "chips": 1, "why": "a test"})
    for metric in spec["end_to_end"]:
        if metric["name"] == "train_samples_per_s":
            metric["workloads"].append(cell)
    spec["per_layer"].append({"name": "loader_wait_ms.features", "unit": "ms",
                              "better": "lower", "source": "host_clock", "layer": "data",
                              "moves": "train_samples_per_s", "workloads": [cell]})
    spec["per_layer"].append({"name": "steps.features", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "task",
                              "moves": "train_samples_per_s", "workloads": [cell]})
    spec["per_layer"].append({"name": "mfu.features", "unit": "%", "better": "higher",
                              "source": "host_clock", "layer": "model",
                              "moves": "train_samples_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


def run(tmp_path, bench, trace):
    done = subprocess.run([sys.executable, "-c", RUN, str(bench), str(small.ROOT), str(trace)],
                          capture_output=True, text=True, cwd=tmp_path, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_a_cell_without_ocr_keys_runs_from_new_files(tmp_path):
    bench = new_cell(tmp_path)
    plain = run(tmp_path, bench, 0)
    assert set(plain["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert plain["attempted"] > 0 and plain["failed"] == 0
    assert plain["correct"] is False and list(plain["checks"]) == ["loss_gap",
                                                                  "input_mismatches"]
    traced = run(tmp_path, bench, 1)
    assert set(traced["metrics"]) == {"loader_wait_ms.features", "mfu.features",
                                      "steps.features"}
    assert traced["metrics"]["mfu.features"]["value"] > 0
    assert traced["metrics"]["steps.features"]["value"] == traced["attempted"] // 4

"""The port's multi-process layer on the CPU: the loader's process sharding
against the JAX package's, and two real gloo processes (``torch.distributed``)
for the shards, ``gather_eval_dicts``, a DDP step and the global-batch loss.

Every multi-process test starts its workers with the ``spawn`` context on a
free port (bound to port 0 first) and joins them within a time limit of its
own (:data:`JOIN_SECONDS`), so a stuck rendezvous fails one test and cannot
hold up the suite.  The workers import the port only (the JAX package is
imported in this process, where a test needs it).  ``run_ranks`` and the
small task configs are shared with ``test_torch_port_scale_out.py`` and
``test_torch_port_tools.py``.
"""

import os
import queue
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.data.loader import DataLoader
from openvivqa_tpu_torch.parallel import multihost
from openvivqa_tpu_torch.utils.instance import Instance

JOIN_SECONDS = 120
D, K = 32, 8


# -- the two-process harness ---------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _entry(rank, world, port, fn, args, results):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(2)
    try:
        multihost.initialize("cpu")
        results.put((rank, "ok", fn(rank, *args)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))  # reported to the test
        raise
    finally:
        multihost.finalize()


def run_ranks(fn, *args, world=2):
    """fn(rank, *args) in `world` spawned processes joined in one gloo group;
    the list of their results by rank.  A worker's exception, or no result
    within JOIN_SECONDS, fails the test (every worker is then terminated)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(rank, world, port, fn, args, results),
                         daemon=True) for rank in range(world)]
    for proc in procs:
        proc.start()
    out, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, status, value = results.get(timeout=JOIN_SECONDS)
            except queue.Empty:
                pytest.fail(f"no result from the workers within {JOIN_SECONDS} s")
            if status == "error":
                errors.append(f"rank {rank}:\n{value}")
                break
            out[rank] = value
    finally:
        for proc in procs:
            proc.join(timeout=10 if not errors else 1)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
    assert not errors, "\n".join(errors)
    return [out[rank] for rank in range(world)]


# -- small task configs (the port's tests at narrow widths) -----------------------------------
def _vocab(paths, kind, **extra):
    jp = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]}
    return {"TYPE": kind, "TOKENIZER": None, "MIN_FREQ": 1, "WORD_EMBEDDING": None,
            "WORD_EMBEDDING_CACHE": None, "PAD_TOKEN": "<pad>", "BOS_TOKEN": "<bos>",
            "EOS_TOKEN": "<eos>", "UNK_TOKEN": "<unk>", "JSON_PATH": jp, **extra}


OCR_TOKENS = {"IMG_TOKEN": "<img>", "FEAT_TOKEN": "<feat>", "BOX_TOKEN": "<box>",
              "OCR_TOKEN": "<ocr>", "OCR_DET_TOKEN": "<ocr_det>", "OCR_REC_TOKEN": "<ocr_rec>",
              "QUESTION_TOKEN": "<question>", "ANSWER_TOKEN": "<answer>"}


def mmf_m4c_config(paths, root, batch_size=8, dropout=0.1, name="mmf_m4c_scale_out",
                   **training):
    """TrainingMMF with a two-layer, 32-wide MMF_M4C."""
    common = {"MAX_REGIONS": 36, "SCENE_TEXT_THRESHOLD": 0.3, "MAX_SCENE_TEXT": K,
              "WORD_EMBEDDING": None, "BATCH_SIZE": batch_size, "WORKERS": 1,
              "FEATURE_PATH": {"FEATURES": paths["features"], "SCENE_TEXT": paths["scene_text"]}}
    jp = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]}
    return ConfigNode({
        "TASK": "TrainingMMF",
        "DATASET": {
            "FEATURE_DATASET": dict(common, TYPE="OcrFeatureDataset"),
            "DICT_DATASET": dict(common, TYPE="OcrDictionaryDataset"),
            "VOCAB": _vocab(paths, "OcrVocab", **OCR_TOKENS), "JSON_PATH": jp,
        },
        "TRAINING": {
            "CHECKPOINT_PATH": str(root), "LEARNING_RATE": 1.0, "WARMUP": 100,
            "SCORE": "CIDEr", "TRAINING_BEAM_SIZE": 2, "EVALUATING_BEAM_SIZE": 2,
            "PATIENCE": 2, "MAX_EPOCHS": 1, "SEED": 5, **training,
        },
        "MODEL": {
            "NAME": name, "ARCHITECTURE": "MMF_M4C", "D_MODEL": D,
            "MMT": {"HIDDEN_SIZE": D, "NUM_HIDDEN_LAYERS": 2, "NUM_ATTENTION_HEADS": 2},
            "TEXT_BERT": {"HIDDEN_SIZE": D, "NUM_HIDDEN_LAYERS": 1, "LOAD_PRETRAINED": False},
            "OBJECT_EMBEDDING": {"D_FEATURE": 1024, "DROPOUT": dropout},
            "OCR_EMBEDDING": {"D_FEATURE": 300 + 256 + 256, "DROPOUT": dropout},
            "OCR_PTR_NET": {"HIDDEN_SIZE": D, "QUERY_KEY_SIZE": D},
        },
    })


def _attention(dropout):
    return {"ARCHITECTURE": "ScaledDotProductAttention", "HEAD": 2, "D_MODEL": D, "D_KEY": 16,
            "D_VALUE": 16, "D_FF": 2 * D, "USE_AOA": False, "CAN_BE_STATEFUL": False,
            "DROPOUT": dropout}


def classification_config(paths, root, arch="SAAA", batch_size=8, dropout=0.1, **training):
    """ClassificationTask with a 32-wide SAAA (its LSTM text processor) or MCAN."""
    vision = {"ARCHITECTURE": "FeatureEmbedding", "D_FEATURE": 1024, "D_MODEL": D,
              "DROPOUT": dropout}
    text = {"ARCHITECTURE": "LSTMTextEmbedding", "D_MODEL": D, "D_EMBEDDING": 24,
            "DROPOUT": dropout, "WORD_EMBEDDING": None, "WORD_EMBEDDING_CACHE": None}
    model = {"NAME": f"{arch.lower()}_scale_out", "ARCHITECTURE": arch, "D_MODEL": D}
    if arch == "SAAA":
        model.update({"VISION_PROCESSOR": vision, "TEXT_PROCESSOR": text,
                      "ATTENTION": {"D_VISION": D, "D_LANGUAGE": D, "D_MODEL": D,
                                    "DROPOUT": dropout, "GLIMPSES": 2}})
    else:
        attn = _attention(dropout)
        reduce = {"D_MODEL": D, "DROPOUT": dropout}
        model.update({
            "VISION_EMBEDDING": vision, "TEXT_EMBEDDING": text,
            "SELF_ENCODER": {"ARCHITECTURE": "Encoder", "D_MODEL": D, "LAYERS": 2,
                             "SELF_ATTENTION": attn},
            "GUIDED_ENCODER": {"ARCHITECTURE": "GuidedAttentionEncoder", "D_MODEL": D,
                               "LAYERS": 2, "SELF_ATTENTION": attn, "GUIDED_ATTENTION": attn},
            "VISION_ATTR_REDUCE": reduce, "TEXT_ATTR_REDUCE": reduce})
    jp = {"TRAIN": paths["train"], "DEV": paths["dev"], "TEST": paths["test"]}
    return ConfigNode({
        "TASK": "ClassificationTask",
        "DATASET": {
            "FEATURE_DATASET": {"TYPE": "FeatureClassificationDataset", "BATCH_SIZE": batch_size,
                                "WORKERS": 1, "MAX_REGIONS": 36,
                                "FEATURE_PATH": {"FEATURES": paths["features"]}},
            "VOCAB": _vocab(paths, "ClassificationVocab"), "JSON_PATH": jp,
        },
        "TRAINING": {
            "CHECKPOINT_PATH": str(root), "LEARNING_RATE": 0.1, "WARMUP": 100,
            "SCORE": "CIDEr", "GET_SCORES": True, "PATIENCE": 2, "MAX_EPOCHS": 1, "SEED": 7,
            **training,
        },
        "MODEL": model,
    })


def _seeded_by_index(getitem):
    def draw(index):
        np.random.seed(int(index))
        return getitem(index)

    return draw


def build(config):
    """The task of `config` on the CPU.  Its datasets draw from numpy's
    global generator (an answer word that is both in the vocab and among the
    OCR tokens takes either index, the reference's rule), so each sample's
    draw is seeded by its index: a sample is then the same whichever process
    and batch read it."""
    from openvivqa_tpu_torch.builders import build_task, populate

    populate()
    task = build_task(config, "cpu")
    for name, dataset in vars(task).items():
        if name.endswith("_dataset") and dataset is not None:
            dataset.__getitem__ = _seeded_by_index(dataset.__getitem__)
    return task


def params_of(task):
    return {name: p.detach().clone().numpy() for name, p in task.model.state_dict().items()}


# -- the loader's shards -----------------------------------------------------------------------
class TinyDataset:
    def __len__(self):
        return 12

    def __getitem__(self, idx):
        return Instance(x=np.asarray([idx], np.int32))


def _batches(loader):
    return [[int(v) for v in batch["x"][:, 0]] for batch in loader]


@pytest.mark.parametrize("num_shards", [2, 3])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_shards_match_the_jax_package(num_shards, shuffle):
    """12 samples in batches of 2: each shard's batches, and its length,
    equal the JAX DataLoader's with the same explicit num_shards / shard_id
    and seed, for two epochs; the shards are disjoint and cover the data."""
    from openvivqa_tpu.data.loader import DataLoader as JaxDataLoader
    from openvivqa_tpu.utils.instance import Instance as JaxInstance

    class JaxTinyDataset(TinyDataset):
        def __getitem__(self, idx):
            return JaxInstance(x=np.asarray([idx], np.int32))

    covered = []
    for shard_id in range(num_shards):
        kwargs = dict(batch_size=2, shuffle=shuffle, seed=3, num_workers=1, prefetch=1,
                      num_shards=num_shards, shard_id=shard_id)
        ours, theirs = DataLoader(TinyDataset(), **kwargs), JaxDataLoader(JaxTinyDataset(),
                                                                          **kwargs)
        assert len(ours) == len(theirs) == -(-6 // num_shards)
        for _ in range(2):
            got = _batches(ours)
            assert got == _batches(theirs)
        covered += [i for batch in got for i in batch]
    assert sorted(covered) == list(range(12))


def test_loader_wrap_pads_every_shard_to_one_count():
    """Fewer batches than a multiple of the shards: each shard gets the
    ceiling, the tail wrapped around from the first batches, even with more
    shards than batches."""
    for n_shards, want in ((4, 2), (8, 1)):
        loaders = [DataLoader(TinyDataset(), batch_size=2, num_workers=1, num_shards=n_shards,
                              shard_id=s) for s in range(n_shards)]
        shards = [_batches(loader) for loader in loaders]
        assert [len(s) for s in shards] == [len(loader) for loader in loaders] == [want] * n_shards
        assert sorted({i for s in shards for b in s for i in b}) == list(range(12))


# -- two gloo processes ---------------------------------------------------------------------
def _shards_and_gather(rank):
    loader = DataLoader(TinyDataset(), batch_size=2, shuffle=True, seed=9, num_workers=1,
                        prefetch=1)
    assert (multihost.process_count(), multihost.process_index()) == (2, rank)
    gts = {f"q{rank}": [f"ground truth {rank}"], "q7": ["shared"]}
    gens = {f"q{rank}": [f"càfé généré {rank}"], "q7": ["tête-à-tête"]}
    merged_gts, merged_gens = multihost.gather_eval_dicts(gts, gens)
    return {"batches": _batches(loader), "len": len(loader), "gts": merged_gts,
            "gens": merged_gens, "primary": multihost.is_primary()}


def test_two_processes_shard_the_loader_and_gather_eval_dicts():
    """Two processes: disjoint round-robin shards of one shuffled order that
    cover the 12 samples, 3 batches each; both hold the merged eval dicts
    under the raw keys (the key both processes scored, q7, once), non-ASCII
    strings intact; only rank 0 is primary."""
    results = run_ranks(_shards_and_gather)
    flat = [[i for batch in r["batches"] for i in batch] for r in results]
    assert not set(flat[0]) & set(flat[1])
    assert sorted(flat[0] + flat[1]) == list(range(12))
    order = DataLoader(TinyDataset(), batch_size=2, shuffle=True, seed=9, num_workers=1)
    single = _batches(order)
    assert results[0]["batches"] == single[0::2] and results[1]["batches"] == single[1::2]
    for r in results:
        assert r["len"] == 3
        assert r["gts"] == {"q0": ["ground truth 0"], "q1": ["ground truth 1"],
                            "q7": ["shared"]}
        assert r["gens"] == {"q0": ["càfé généré 0"], "q1": ["càfé généré 1"],
                             "q7": ["tête-à-tête"]}
    assert [r["primary"] for r in results] == [True, False]


def test_one_process_helpers_answer_for_one_process():
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.is_primary()
    gts, gens = {"h0_0_0": ["a"]}, {"h0_0_0": ["b"]}
    assert multihost.gather_eval_dicts(gts, gens) == (gts, gens)
    multihost.initialize("cpu")  # no WORLD_SIZE > 1: a no-op
    assert not torch.distributed.is_initialized()


# -- a tiny model's DDP step -------------------------------------------------------------------
def _tiny_model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(), torch.nn.Linear(16, 5))


def _tiny_batch():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))
    targets = torch.tensor([2, 0, 0, 3, 3, 1, 4, 2])  # 0 is ignored: 2 valid rows, then 4
    return x, targets


def _tiny_step(model, x, targets, forward=None):
    from openvivqa_tpu_torch.training.train_state import nll_loss

    optimizer = torch.optim.Adam(model.parameters(), lr=1e-2)
    logits = (forward or model)(x)
    loss = nll_loss(torch.log_softmax(logits, -1), targets, 0)
    loss.backward()
    grads = [p.grad.detach().clone().numpy() for p in model.parameters()]
    optimizer.step()
    return float(loss.detach()), grads, [p.detach().clone().numpy() for p in model.parameters()]


def _tiny_ddp_step(rank):
    from openvivqa_tpu_torch.parallel.mesh import get_mesh, wrap_for_training

    model = _tiny_model()
    ddp = wrap_for_training(model, get_mesh("cpu"), fsdp=False)
    x, targets = _tiny_batch()
    rows = slice(4 * rank, 4 * rank + 4)
    return _tiny_step(model, x[rows], targets[rows], forward=ddp)


def test_ddp_step_with_unequal_valid_counts_equals_the_global_step():
    """A tiny model's DDP step, each rank on half of a batch of 8 whose
    rows ignored by nll_loss fall unevenly (2 valid rows on rank 0, 4 on
    rank 1): the loss is the global masked mean and the gradient and the Adam
    update equal one process's full-batch step, within 1e-6; a mean of the
    ranks' local means would weigh rank 0's rows twice as much as rank 1's."""
    want_loss, want_grads, want_params = _tiny_step(_tiny_model(), *_tiny_batch())
    for loss, grads, params in run_ranks(_tiny_ddp_step):
        assert loss == pytest.approx(want_loss, abs=1e-6)
        for got, want in zip(grads + params, want_grads + want_params):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _masked_means(rank):
    from openvivqa_tpu_torch.training.train_state import bce_with_logits_loss, nll_loss

    rng = np.random.default_rng(rank)
    logprobs = torch.log_softmax(torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32)),
                                 -1).requires_grad_()
    targets = torch.from_numpy(rng.integers(0, 4, 6))
    weights = torch.tensor([1.0] * (3 + 2 * rank) + [0.0] * (3 - 2 * rank))
    scores = torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32)).requires_grad_()
    out = []
    for loss in (nll_loss(logprobs, targets, 0, weights), bce_with_logits_loss(scores, targets,
                                                                              weights)):
        loss.backward()
        out.append(float(loss.detach()))
    return out, logprobs.grad.numpy(), scores.grad.numpy()


def test_loss_values_and_gradients_are_the_global_masked_means():
    """nll_loss and bce_with_logits_loss under a process group, with 3 and 5
    weighted rows on the two ranks: both ranks report the global masked mean
    of a single process over the 12 rows, and each rank's gradient is world
    times its share of the global gradient (the reduction's mean of the two
    is then the global one)."""
    from openvivqa_tpu_torch.training.train_state import bce_with_logits_loss, nll_loss

    results = run_ranks(_masked_means)
    parts = []
    for rank in range(2):
        rng = np.random.default_rng(rank)
        parts.append((rng.normal(size=(6, 4)).astype(np.float32), rng.integers(0, 4, 6),
                      rng.normal(size=(6, 4)).astype(np.float32)))
    logprobs = torch.log_softmax(torch.from_numpy(np.concatenate([p[0] for p in parts])),
                                 -1).requires_grad_()
    targets = torch.from_numpy(np.concatenate([p[1] for p in parts]))
    weights = torch.tensor([1.0] * 3 + [0.0] * 3 + [1.0] * 5 + [0.0])
    scores = torch.from_numpy(np.concatenate([p[2] for p in parts])).requires_grad_()
    nll, bce = nll_loss(logprobs, targets, 0, weights), bce_with_logits_loss(scores, targets,
                                                                              weights)
    (nll + bce).backward()
    for rank, (values, lp_grad, sc_grad) in enumerate(results):
        assert values == pytest.approx([float(nll.detach()), float(bce.detach())], abs=1e-6)
        rows = slice(6 * rank, 6 * rank + 6)
        np.testing.assert_allclose(lp_grad / 2, logprobs.grad[rows].numpy(), atol=1e-6)
        np.testing.assert_allclose(sc_grad / 2, scores.grad[rows].numpy(), atol=1e-6)

"""The port's tools against the JAX package's: the profiler hook and the
record of the training epochs (``training/profiling.py``), and the
reference-checkpoint migration (``tools/migrate_checkpoint.py``), whose
output must resume and give the JAX-migrated task's outputs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvivqa_tpu import builders as jax_builders
from openvivqa_tpu.config import ConfigNode as JaxConfigNode
from openvivqa_tpu.models.modules import torch_conversion
from openvivqa_tpu.tools.migrate_checkpoint import migrate as jax_migrate
from openvivqa_tpu_torch.config import ConfigNode
from openvivqa_tpu_torch.models.convert import params_from_flax
from openvivqa_tpu_torch.tools import migrate_checkpoint
from openvivqa_tpu_torch.training.profiling import maybe_trace
from test_torch_port_multihost import build, classification_config, mmf_m4c_config

jax_builders.populate()


# -- the profiler hook and the epoch record ----------------------------------------------------
def test_maybe_trace_writes_a_chrome_trace_only_when_enabled(tmp_path):
    with maybe_trace(None):
        pass
    with maybe_trace(str(tmp_path / "off"), enabled=False):
        torch.ones(4).sum()
    assert not (tmp_path / "off").exists()
    with maybe_trace(str(tmp_path / "on")):
        torch.ones(4).sum()
    (trace,) = (tmp_path / "on").iterdir()
    assert json.loads(trace.read_text())["traceEvents"]


@pytest.mark.parametrize("kind", ["MMF_M4C", "SAAA"])
def test_train_epochs_trace_epoch_0_and_log_the_step_timer(synthetic_data, tmp_path, kind):
    """TRAINING.PROFILE_DIR: the train epoch writes one trace at epoch 0 and
    none after; epoch 0's train record in metrics.jsonl carries the spans it
    recorded under the profiler (one train.step and one data.put_batch a
    step, each step's forward, backward and optimizer inside it, and a
    data.wait for each batch and for each of the two prefetch slots that find
    the split at its end), epoch 1's none."""
    profile_dir = tmp_path / "profile"
    make = mmf_m4c_config if kind == "MMF_M4C" else classification_config
    task = build(make(synthetic_data, tmp_path / "ckpt", PROFILE_DIR=str(profile_dir)))
    task.train()
    assert len(list(profile_dir.iterdir())) == 1
    task.epoch = 1
    task.train()
    assert len(list(profile_dir.iterdir())) == 1
    with open(os.path.join(task.checkpoint_path, "metrics.jsonl")) as handle:
        records = [json.loads(line) for line in handle]
    assert [r["epoch"] for r in records] == [0, 1]
    steps = len(task.train_dataloader)
    assert [r["iterations"] for r in records] == [steps, steps]
    spans = records[0]["spans"]
    for name in ("train.step", "train.forward", "train.backward", "train.optimizer",
                 "data.put_batch"):
        assert spans[name]["count"] == steps, name
    assert spans["data.wait"]["count"] == steps + 2
    step = spans["train.step"]
    parts = sum(spans[name]["total_ms"] for name in ("train.forward", "train.backward",
                                                     "train.optimizer"))
    assert 0.0 < step["self_ms"] <= step["total_ms"]
    assert step["total_ms"] - step["self_ms"] == pytest.approx(parts, rel=1e-6)
    assert 0.0 < step["max_ms"] <= step["total_ms"]
    assert "spans" not in records[1]


# -- the checkpoint migration --------------------------------------------------------------------
def _reference_checkpoint(kind, synthetic_data, tmp_path):
    """A config of `kind`, its model's flax init on one train batch and a
    reference-layout checkpoint of those weights (the torch names, written
    through params_from_flax) with the reference's metadata."""
    if kind == "MMF_M4C":
        config = mmf_m4c_config(synthetic_data, tmp_path / "port", dropout=0.0, MAX_EPOCHS=9)
    else:
        config = classification_config(synthetic_data, tmp_path / "port", arch="MCAN",
                                       dropout=0.0, MAX_EPOCHS=9)
    task = build(config)
    host = next(iter(task.train_dataloader))
    batch = {key: jnp.asarray(value) for key, value in host.arrays().items()}
    jax_config = JaxConfigNode(config.to_dict())
    jax_model = jax_builders.META_ARCHITECTURE.get(kind)(jax_config.MODEL, task.vocab)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda r, b: jax_model.init({"params": r, "dropout": r}, b, train=False))(
        jax.random.PRNGKey(3), batch)["params"])
    path = tmp_path / "reference_best.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in params_from_flax(params).items()},
                "epoch": 7, "best_val_score": 0.5, "patience": 1}, path)
    return config, jax_config, str(path), host


def _outputs(out):
    return np.asarray(out["scores"] if isinstance(out, dict) else out)


@pytest.mark.parametrize("kind", ["MMF_M4C", "MCAN"])
def test_migrated_checkpoint_resumes_and_matches_the_jax_migration(synthetic_data, tmp_path,
                                                                   kind):
    """A reference-layout checkpoint migrated by both packages: the port's
    last_model.pth and best_model.pth load into a fresh task at the saved
    epoch with the reference's metadata, its eval outputs on one batch equal
    the JAX-migrated task's within 1e-4 (the whole-model parity bound of the
    port's family tests), and start() resumes at the next epoch."""
    config, jax_config, path, host = _reference_checkpoint(kind, synthetic_data, tmp_path)
    last = migrate_checkpoint.migrate(config, path, also_best=True, device="cpu")
    assert os.path.isfile(last) and os.path.isfile(last.replace("last_model", "best_model"))
    jax_config = jax_config.merged({"TRAINING": {"CHECKPOINT_PATH": str(tmp_path / "jax")}})
    jax_last = jax_migrate(jax_config, path)

    task = build(config)
    metadata = task.load_checkpoint(last)
    assert metadata == {"epoch": 7, "step": 0, "best_val_score": 0.5, "patience": 1,
                        "use_rl": False}
    jax_task = jax_builders.build_task(jax_config)
    assert jax_task.load_checkpoint(jax_last)["epoch"] == 7
    batch = {key: jnp.asarray(value) for key, value in host.arrays().items()}
    want = _outputs(jax_task.model.apply(jax_task.state.variables(), batch, train=False))
    with torch.no_grad():
        got = _outputs(task.model.eval()(task.put_batch(host)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    task.start()
    with open(os.path.join(task.checkpoint_path, "metrics.jsonl")) as handle:
        assert {json.loads(line)["epoch"] for line in handle} == {8}


def test_sharded_backend_writes_a_dcp_directory_that_resumes_and_promotes(
        synthetic_data, tmp_path, monkeypatch):
    """OPENVIVQA_CKPT_BACKEND=orbax: the state goes to last_model.pth.dcp
    (torch.distributed.checkpoint) and the .pth holds only the host payload;
    promote copies the directory; a fresh task resumes the weights, Adam's
    moments and the generator exactly; a later save with the default backend
    removes the stale directory, which would otherwise shadow it."""
    from openvivqa_tpu_torch.training.checkpoint import BEST_NAME, LAST_NAME, promote

    config = mmf_m4c_config(synthetic_data, tmp_path)
    task = build(config)
    task._train_step(next(task.device_batches(task.train_dataloader))[1])
    monkeypatch.setenv("OPENVIVQA_CKPT_BACKEND", "orbax")
    task.save_checkpoint({"best_val_score": 0.25, "patience": 0})
    last = os.path.join(task.checkpoint_path, LAST_NAME)
    best = os.path.join(task.checkpoint_path, BEST_NAME)
    assert os.path.isdir(last + ".dcp")
    assert "model" not in torch.load(last, weights_only=False)
    promote(last, best)
    assert os.path.isdir(best + ".dcp")

    resumed = build(config)
    metadata = resumed.load_checkpoint(best)
    assert metadata == {"epoch": 0, "step": 1, "best_val_score": 0.25, "patience": 0}
    for (name, p), q in zip(task.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(p, q), name
    for p, q in zip(task.model.parameters(), resumed.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(task.optimizer.state[p][key], resumed.optimizer.state[q][key])
    assert torch.equal(resumed.generator.get_state(), task.generator.get_state())

    monkeypatch.delenv("OPENVIVQA_CKPT_BACKEND")
    task.save_checkpoint({"best_val_score": 0.25, "patience": 0})
    assert not os.path.isdir(last + ".dcp")
    assert "model" in torch.load(last, weights_only=False)


def test_migration_refuses_a_checkpoint_that_does_not_fit_the_model(synthetic_data, tmp_path):
    config, _, path, _ = _reference_checkpoint("MCAN", synthetic_data, tmp_path)
    state = torch.load(path, weights_only=False)
    name = next(iter(state["state_dict"]))
    missing = dict(state, state_dict={k: v for k, v in state["state_dict"].items() if k != name})
    torch.save(missing, tmp_path / "missing.pth")
    with pytest.raises(ValueError, match="missing"):
        migrate_checkpoint.migrate(config, str(tmp_path / "missing.pth"), device="cpu")
    wide = dict(state, state_dict={**state["state_dict"], name: torch.zeros(3, 5, 7)})
    torch.save(wide, tmp_path / "wide.pth")
    with pytest.raises(ValueError, match="shape mismatches"):
        migrate_checkpoint.migrate(config, str(tmp_path / "wide.pth"), device="cpu")


def test_migration_table_and_refusals_match_the_jax_package():
    """The same architectures, and for each one the JAX converters refuse,
    the same NotImplementedError word for word; an architecture the table
    lacks gets the same message too."""
    assert sorted(migrate_checkpoint.MODEL_CONVERTERS) == sorted(torch_conversion.MODEL_CONVERTERS)
    refused = [name for name, entry in migrate_checkpoint.MODEL_CONVERTERS.items()
               if entry is not True]
    assert sorted(refused) == ["MMF_IterativeLoRRA", "MMF_SAL", "experimental_MMF_M4C"]
    for name in refused + ["IterativeM4C"]:
        with pytest.raises(NotImplementedError) as theirs:
            torch_conversion.convert_reference_checkpoint({"state_dict": {}},
                                                          JaxConfigNode({"ARCHITECTURE": name}))
        with pytest.raises(NotImplementedError) as ours:
            migrate_checkpoint.convert_reference_checkpoint(
                {"state_dict": {}}, ConfigNode({"ARCHITECTURE": name}), torch.nn.Linear(1, 1))
        assert str(ours.value) == str(theirs.value)

"""`correct` on the CPU at small widths: sound runs of each cell come out
correct, and a run with its timed path broken underneath comes out not
correct, once for each fault the cell can have (one chip: no exchange between
chips to leave out)."""

import portbench_small as small
import pytest

CELLS = ["mmf_m4c.train_xe", "mmf_m4c.eval_greedy"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result = small.run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert {"setup_s"} < set(result["metrics"])


def test_a_traced_run_reports_per_layer_metrics():
    result = small.run("mmf_m4c.train_xe", trace=1)
    assert result["correct"]
    assert {"loader_wait_ms.train", "mfu.train"} <= set(result["metrics"])
    assert "setup_s" not in result["metrics"] and "breakdown" in result


@pytest.mark.parametrize("cell", CELLS[:1])
def test_a_step_that_leaves_the_state_unchanged_is_caught(cell, monkeypatch):
    from openvivqa_tpu_torch.training.tasks.open_ended_task import OpenEndedTask

    def unchanged(self, batch):  # the loss and its gradients, and no update
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.train_forward(self.compute_loss, batch)
        loss.backward()
        return loss.detach()

    monkeypatch.setattr(OpenEndedTask, "_train_step", unchanged)
    result = small.run(cell)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] > result["checks"]["change_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS[:1])
def test_half_the_batch_left_out_is_caught(cell, monkeypatch):
    from openvivqa_tpu_torch.training.tasks.ocr_tasks import TrainingMMF

    whole = TrainingMMF.compute_loss

    def half(self, batch):
        valid = batch["sample_valid"].clone()
        valid[valid.shape[0] // 2:] = 0
        return whole(self, {**batch, "sample_valid": valid})

    monkeypatch.setattr(TrainingMMF, "compute_loss", half)
    result = small.run(cell)
    assert not result["correct"]
    assert result["checks"]["loss_gap"]["value"] > result["checks"]["loss_gap"]["limit"]


def test_a_token_altered_where_it_is_produced_is_caught(monkeypatch):
    from openvivqa_tpu_torch.training.tasks.ocr_tasks import TrainingMMF

    greedy = TrainingMMF.greedy_ids

    def altered(self, device_batch):
        ids = greedy(self, device_batch).clone()
        ids[0, -1] = 1 + ids[0, -1] % 7  # another vocabulary word
        return ids

    monkeypatch.setattr(TrainingMMF, "greedy_ids", altered)
    result = small.run("mmf_m4c.eval_greedy")
    assert not result["correct"]
    assert result["checks"]["served_gap"]["value"] > 0

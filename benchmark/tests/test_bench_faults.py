"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (the tiny CPU size of each cell), the
rest of the run is driven, and a fault is planted in the program: a step
that leaves its state unchanged, half of the batch left out of the loss
(the mean over the rest), an answer altered where it is produced. The
program runs in fp32 there, where a sound run reads zero on every number
(``test_bench_reference.py``), so that the fault alone moves them. And the
correctness control (the reference at three mantissa bits in the program's
place) reads further off than the program does."""
import pytest
import torch

import tiny
from benchmark.harness import control


def half_loss(original):
    def loss(cfg, out, aux, batch, gt, host_ids=None):
        h = batch.points.shape[0] // 2
        return original(cfg, type(out)(*(x[:, :h] for x in out)),
                        type(aux)(*(x[:h] for x in aux)), type(batch)(*(x[:h] for x in batch)),
                        type(gt)(*(x[:h] for x in gt)),
                        None if host_ids is None else host_ids[:h])
    return loss


@pytest.mark.parametrize("name", ["joint-train-staged", "scannet-train-loader"])
def test_state_left_unchanged(name, monkeypatch):
    from unidet3d_tpu_torch.train import optim

    monkeypatch.setattr(optim.ClippedAdamW, "step", lambda self: torch.zeros(()))
    line = tiny.run(name, compute_dtype="float32")
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["joint-train-staged", "scannet-train-loader"])
def test_half_the_batch_left_out(name, monkeypatch):
    from unidet3d_tpu_torch.parallel import train_step

    monkeypatch.setattr(train_step, "detection_loss", half_loss(train_step.detection_loss))
    line = tiny.run(name, compute_dtype="float32")
    assert line["correct"] is False, line["checks"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from unidet3d_tpu_torch.train import loop

    original = loop.predict_batch

    def altered(*args, **kw):
        det = original(*args, **kw)
        return det._replace(scores=det.scores * 0.99)

    monkeypatch.setattr(loop, "predict_batch", altered)
    line = tiny.run("joint-eval", compute_dtype="float32")
    assert line["correct"] is False
    assert line["checks"]["post_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", ["joint-train-staged", "joint-eval", "scannet-eval"])
def test_the_control_reads_further_off_than_the_program(name, tmp_path):
    wl = tiny.workload(name)
    ctx = tiny.context(wl, 5, str(tmp_path))
    if wl["driver"] == "eval":
        read = control.eval_readings(ctx)["control"]
        keys = ("fwd_logits_gap", "fwd_boxes_gap")
    else:
        read = control.training_readings(ctx)["control"]
        keys = ("loss_gap", "grad_gap")
    mine = {k: c["value"] for k, c in tiny.run(name, seed=5)["checks"].items()}
    assert all(read[k] > mine[k] for k in keys), (read, mine)
    assert control.verdict(wl["limits"], read)["correct"] is False, read

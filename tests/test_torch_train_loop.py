"""The port's fault-tolerant training loop and its CLI, on the CPU: a run
that fails at step 5 and resumes from its step-4 checkpoint ends at the
parameters and moments of an uninterrupted run, bit for bit; the loss falls
on a fixed batch (the reference's ``test_loss_decreases``); and
``launch.train`` runs, checkpoints and resumes.
"""
import pytest
import torch

from repro_torch.launch import train as launch_train
from repro_torch.train import checkpoint as CK
from repro_torch.train.loop import LoopConfig, SimulatedFailure, run
from repro_torch.train.optimizer import AdamWConfig

from test_torch_train_ckpt import batch_fn, setup


def test_loop_restart_after_failure_is_bitwise(tmp_path):
    """Crash at step 5, restart from the step-4 checkpoint, finish: the
    parameters, moments and step of an uninterrupted run, bit for bit."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    quiet = lambda s: None
    model, opt, step = setup()
    p_ref, o_ref, _ = run(LoopConfig(total_steps=6, ckpt_dir=d1, ckpt_every=4),
                          step, model, opt, batch_fn, log=quiet)
    model, opt, step = setup()
    with pytest.raises(SimulatedFailure):
        run(LoopConfig(total_steps=6, ckpt_dir=d2, ckpt_every=4, fail_at_step=5),
            step, model, opt, batch_fn, log=quiet)
    model, opt, step = setup()
    p_fin, o_fin, hist = run(LoopConfig(total_steps=6, ckpt_dir=d2, ckpt_every=4),
                             step, model, opt, batch_fn, log=quiet)
    assert [h["step"] for h in hist] == [4, 5]        # resumed, not restarted
    assert o_fin["step"] == o_ref["step"] == 6
    for a, b in zip(p_ref.parameters(), p_fin.parameters()):
        assert torch.equal(a, b)
    for k in ("mu", "nu"):
        for a, b in zip(o_ref[k], o_fin[k]):
            assert torch.equal(a, b)


def test_loss_decreases():
    """The reference's ``test_loss_decreases``: twelve steps on one batch."""
    model, opt, step = setup(AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=50,
                                         weight_decay=0.0))
    batch = batch_fn(0)
    losses = []
    for _ in range(12):
        model, opt, m = step(model, opt, batch)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 0.3, losses


def test_launch_train_runs_and_resumes(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu``: two steps
    and the terminal checkpoint; a second call with more steps resumes."""
    d = str(tmp_path / "ck")
    for steps in (2, 3):
        monkeypatch.setattr("sys.argv", ["train", "--smoke", "--device", "cpu", "--steps",
                                         str(steps), "--seq", "16", "--ckpt-dir", d])
        launch_train.main()
        out = capsys.readouterr().out
        assert "[train] done: final loss" in out, out
    assert "resumed from checkpoint step 2" in out
    assert CK.latest_step(d) == 3

"""The port's training launcher, ``python -m repro_torch.launch.train``,
against the reference's ``repro.launch.train`` on the CPU.

* Every argv parses to the reference's namespace (the same flags and
  defaults), plus ``--device``, which defaults to ``cuda`` and raises
  without a card.
* ``tiny_config`` lives here as in the reference (field for field the
  reference's for every arch); ``launch.serve`` takes it from here.
* In 100 steps the tiny gemma2's loss falls, which the launcher asserts
  as the reference's does (shorter runs on random synthetic batches do
  not fall reliably in either package), and a run that dies after a
  checkpoint resumes from it to the unbroken run's losses, bit for bit.
  Each test runs on one intra-op thread (``one_thread``).
"""

import argparse
import dataclasses
import json
import sys

import pytest
import torch

import repro.configs.base as jax_cfgs
import repro.launch.train as jax_train
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from tests.test_torch_lm_train import one_thread  # noqa: F401


class _Parsed(Exception):
    pass


def _parsed(main, argv, monkeypatch):
    """The namespace ``main`` parses from ``argv``, stopping there."""
    def stop(self, args=None, namespace=None):
        raise _Parsed(argparse.ArgumentParser.parse_known_args(
            self, args, namespace)[0])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    with pytest.raises(_Parsed) as e:
        main(argv) if main is train_launch.main else main()
    return vars(e.value.args[0])


@pytest.mark.parametrize("argv", [
    [], ["--arch", "mamba2-780m", "--steps", "7", "--batch", "2"],
    ["--seq", "64", "--lr", "1e-3", "--scale", "full", "--ckpt-dir", "d",
     "--ckpt-every", "3", "--log-every", "2"],
    ["--arch", "whisper-large-v3", "--scale", "tiny"]],
    ids=lambda a: " ".join(a) or "none")
def test_launcher_reads_flags_as_the_reference(argv, monkeypatch):
    want = _parsed(jax_train.main, argv, monkeypatch)
    got = _parsed(train_launch.main, argv, monkeypatch)
    assert got.pop("device") == "cuda"
    assert got == want


def test_tiny_config_is_the_reference_one_and_shared_with_serve():
    assert train_launch.ARCH_NAMES == jax_cfgs.ARCH_NAMES
    assert serve_launch.tiny_config is train_launch.tiny_config
    assert serve_launch.TINY_OVERRIDES is train_launch.TINY_OVERRIDES
    assert train_launch.TINY_OVERRIDES == jax_train.TINY_OVERRIDES
    for arch in train_launch.ARCH_NAMES:
        got = dataclasses.asdict(train_launch.tiny_config(arch))
        want = dataclasses.asdict(jax_train.tiny_config(arch))
        assert got == want, arch


def test_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        train_launch.main(["--steps", "1"])


def test_launcher_loss_falls_in_100_steps(capsys):
    """100 steps, where the launcher asserts the fall, of batch 8 x 32 at
    lr 3e-2: cheap on one thread (the defaults' 8 x 256 at 3e-3 falls
    too, 6.2630 -> 6.2444, at eight times the cost)."""
    losses = train_launch.main(["--device", "cpu", "--log-every", "25",
                                "--seq", "32", "--lr", "3e-2"])
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in out[:-1]] == \
        [["step", s] for s in ("0", "25", "50", "75", "99")]
    summary = json.loads(out[-1])
    assert set(summary) == {"first10_loss", "last10_loss", "events"}
    assert summary["last10_loss"] < summary["first10_loss"]
    assert len(losses) == 100


def test_launcher_resumes_to_the_unbroken_losses(tmp_path, monkeypatch,
                                                 capsys):
    """A run that dies at step 8, after its step-5 checkpoint is on disk,
    run again with the same argv: it restores step 5 and its losses from
    step 6 on are the unbroken run's, bit for bit."""
    argv = ["--steps", "12", "--batch", "4", "--seq", "32", "--device",
            "cpu", "--ckpt-every", "5"]
    whole = train_launch.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    real = train_launch.Supervisor.run_step

    def dies_at_8(self, step_fn, state, batch, step):
        if step == 8:
            self._join()                # the step-5 write has finished
            raise RuntimeError("host lost")
        return real(self, step_fn, state, batch, step)

    broken = argv + ["--ckpt-dir", str(tmp_path / "b")]
    monkeypatch.setattr(train_launch.Supervisor, "run_step", dies_at_8)
    with pytest.raises(RuntimeError, match="host lost"):
        train_launch.main(broken)
    monkeypatch.setattr(train_launch.Supervisor, "run_step", real)
    capsys.readouterr()
    resumed = train_launch.main(broken)
    assert "restored checkpoint at step 5" in capsys.readouterr().out
    assert resumed == whole[6:]

"""The port's examples run in-process on the CPU and exit cleanly; without
``--device cpu`` they want a card and raise where there is none."""

import torch
import pytest

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.models import reactnet as rn
from tests.test_torch_paper_workflow import load_example


def test_train_reactnet_example_runs_the_workflow(tmp_path, capsys):
    ex = load_example("torch_train_reactnet")
    ex.main(["--device", "cpu", "--steps", "3", "--batch", "8",
             "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    for line in ("step    0  loss", "step    2  loss", "accuracy  float-sign:",
                 "binary-kernel ratio", "block0/w3: top-64 share",
                 "block1/w3: top-64 share", "compressed checkpoint written"):
        assert line in out, out
    assert ckpt.latest_step(str(tmp_path)) == 3
    like = {"params": rn.init_params(ex.CONFIG, torch.Generator(), "cpu")}
    restored, _ = ckpt.restore(str(tmp_path), like, device="cpu")
    for blk in restored["params"]["blocks"]:       # sign x channel scale
        w3 = blk["w3"]
        assert torch.equal(w3.abs(), w3.abs().amax(dim=(1, 2, 3),
                                                   keepdim=True).expand_as(w3))


def test_quickstart_example_runs(capsys):
    load_example("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "fused decode+conv kernel == reference BNN conv  [OK] (cpu)" in out


@pytest.mark.parametrize("name", ["torch_train_reactnet", "torch_quickstart"])
def test_examples_want_a_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_example(name).main([])

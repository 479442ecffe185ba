"""The launcher serves the paper's other five space networks at their
published widths on every backend, on the CPU plain versions (small
request counts), and needs the card unless asked for the CPU."""
import pytest
import torch

from repro_torch.launch import serve

NEW = ("vae_encoder", "multi_esperta", "logistic_net", "reduced_net",
       "baseline_net")


@pytest.mark.parametrize("backend", ["accel", "flex", "cpu"])
@pytest.mark.parametrize("model", NEW)
def test_launcher_serves_each_network(model, backend, capsys):
    assert serve.main(["--mode", "space", "--model", model, "--backend",
                       backend, "--requests", "6", "--batch", "4",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"[{model}] 6/6 served" in out and f"backends[{backend}:" in out


def test_launcher_co_serves_all_six(capsys):
    names = ",".join(("cnet_plus_scalar",) + NEW)
    assert serve.main(["--mode", "space", "--model", names, "--backend",
                       "flex", "--requests", "2", "--batch", "2",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in names.split(","):
        assert f"[{name}] 2/2 served" in out


def test_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in NEW:
        args = serve.parser().parse_args(["--model", model, "--backend",
                                          "accel", "--requests", "1"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.build_scheduler(args)

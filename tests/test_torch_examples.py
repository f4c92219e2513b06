"""The port's three examples (``examples/torch_*.py``) run to their end on
the CPU (``--device cpu``: the kernels' plain versions) at their default
configs and strategies, cut in steps only where a run would take minutes,
and say what their JAX twins say: the checkpoint round trip is exact, the
four serving strategies keep the healthy run's tokens, training keeps
improving through the NIC failure."""

import importlib.util
import os

import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_trains_checkpoints_and_serves(tmp_path, capsys):
    _load("torch_quickstart").main(["--device", "cpu", "--steps", "30",
                                    "--ckpt", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "checkpoint roundtrip ok at step 30 (params identical: True)" in out
    assert out.count("req ") == 4


def test_serve_resilient_keeps_the_tokens_under_every_strategy(capsys):
    _load("torch_serve_resilient").main(["--device", "cpu"])
    rows = [ln.split() for ln in capsys.readouterr().out.splitlines()
            if ln.split() and ln.split()[0] in ("r2ccl", "dejavu", "reroute", "restart")]
    assert [r[0] for r in rows] == ["r2ccl", "dejavu", "reroute", "restart"]
    assert all(r[-1] == "True" for r in rows)
    assert float(rows[-1][1]) > 35.0           # restart pays the engine relaunch


def test_train_with_failover_keeps_improving(capsys):
    losses = _load("torch_train_with_failover").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 60 and "re-planned collective: r2ccl_all_reduce" in out
    assert "still improving: True" in out


def test_examples_default_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("torch_serve_resilient").main([])


def test_collective_demo_prints_what_the_jax_demo_prints(capsys):
    """The collective demo from the port's copies of the framework-free
    modules says what ``examples/collective_demo.py`` says, line for line."""
    _load("collective_demo").main()
    want = capsys.readouterr().out.splitlines()
    _load("torch_collective_demo").main()
    got = capsys.readouterr().out.splitlines()
    assert len(want) > 20 and got == want

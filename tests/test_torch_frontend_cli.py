"""The port's entry points on the two frontend models, on the CPU: the
training CLI trains paligemma-smoke (patches and text) and hubert-smoke
(frames, the loss masked by ``loss_mask``) on 4 gloo ranks with R2CCL sync
and a NIC failure mid-run, every key of the global batch split over the
ranks; the serving CLI refuses the encoder, as the JAX package's does."""

import json

import numpy as np
import pytest

from repro_torch.data import make_batch
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import get_smoke_config


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_train_cli_smoke_on_cpu(arch, capsys):
    res = train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--world-size", "4", "--steps", "4", "--seq-len", "16",
                          "--batch", "8", "--sync", "r2ccl", "--fail-at-step", "2",
                          "--fail-node", "1", "--nics-per-node", "2", "--log-every", "1"])
    closing = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(closing) == {"first_loss", "last_loss", "decreased"}
    assert res["scheds"] == ["healthy"] * 2 + ["degraded"] * 2
    assert res["located"] is not None and np.isfinite(res["history"]).all()
    # the ranks switched together and report the same loss, the mean over
    # their shares
    ranks = res["ranks"]
    assert len(ranks) == 4
    assert all(r["scheds"] == res["scheds"] and r["history"] == res["history"]
               for r in ranks)


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_rank_batch_split_takes_every_key(arch):
    """The launcher's split (rows ``rank * lb`` to ``(rank + 1) * lb`` of
    every key) hands each rank patches or frames, labels and, for the
    encoder, its loss mask, and the four shares rebuild the global batch."""
    cfg = get_smoke_config(arch)
    b = make_batch(cfg, seq_len=16, batch_size=8, step=0)
    want = {"paligemma-3b": {"patches", "tokens", "labels"},
            "hubert-xlarge": {"frames", "labels", "loss_mask"}}[arch]
    assert set(b) == want
    shares = [{k: v[r * 2:(r + 1) * 2] for k, v in b.items()} for r in range(4)]
    for k, v in b.items():
        np.testing.assert_array_equal(np.concatenate([s[k] for s in shares]), v)


def test_serve_cli_refuses_the_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_cli.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])

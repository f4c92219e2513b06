"""The gradient wire's parts read from rank 0's ``stats``: the wait on the
peers, the staging copies and the bytes sent; each reads None where the run
has nothing for it (a program without the key, an untraced run), and a
traced tiny run on the CPU reads them from the records of ``drivers/train.py``."""

import time

import pytest

from r2bench import harness
from r2bench.drivers import train
from tiny import train_cell

READERS = ("wire_wait_ms.train", "stage_ms.train", "sent_mb.train")
KEYS = {"wire_wait_ms.train": "wait_s", "stage_ms.train": "stage_s",
        "sent_mb.train": "sent_bytes"}


def records(**stats):
    return {"train": {"steps": 4, "stats": dict({"wire_s": 8.0}, **stats)}}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_without_its_key(name):
    read = harness.load_reader(name)
    assert read({}) is None
    assert read({"train": {"steps": 0, "stats": {KEYS[name]: 1.0}}}) is None
    assert read(records()) is None          # the parent's program has no wait_s


def test_readers_on_hand_made_records():
    rec = records(wait_s=6.0, stage_s=1.2, sent_bytes=4 * 1_085_000_000)
    assert harness.load_reader("wire_wait_ms.train")(rec) == pytest.approx(1500.0)
    assert harness.load_reader("stage_ms.train")(rec) == pytest.approx(300.0)
    assert harness.load_reader("sent_mb.train")(rec) == pytest.approx(1085.0)


def test_traced_tiny_failover_run_reads_the_wire_parts():
    cell = train_cell("dp4-nicfail")
    cell.per_layer = [m for m in harness.load_cell("train-smollm-dp4-nicfail").per_layer
                      if m["name"] in READERS + ("wire_ms.train",)]
    ctx = harness.Context(cell=cell, seed=2**31 + 29, seconds=1.5, trace=True,
                          t_process=time.time(), device="cpu")
    line, _ = harness.result(ctx, train.run(ctx))
    assert line["correct"], line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    # the CPU's gloo moves host tensors: no staging copies
    assert set(m) == {"wire_ms.train", "wire_wait_ms.train", "sent_mb.train"}
    assert 0 < m["wire_wait_ms.train"] <= m["wire_ms.train"]
    assert m["sent_mb.train"] > 0

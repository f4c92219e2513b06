"""The generators: the same seed gives the same traffic, every seed the same
work."""

import json

import numpy as np
import pytest

from r2bench import harness
from r2bench.traffic.requests import schedule
from r2bench.traffic.tokens import BigramTokens

MIX = harness.load("traffic", "short-open-loop")


def test_schedule_is_the_same_for_every_run():
    a = schedule(MIX, 45.0)
    assert a == schedule(MIX, 45.0)
    assert a != schedule(dict(MIX, base_seed=MIX["base_seed"] + 1), 45.0)
    assert a[-1].due < 45.0 and len(a) == pytest.approx(MIX["rate"] * 45.0, rel=0.3)


def test_schedule_sizes_and_rate():
    reqs = schedule(MIX, 45.0)
    p, o = MIX["prompt"], MIX["output"]
    assert all(p["min"] <= r.prompt_len <= p["max"] for r in reqs)
    assert all(o["min"] <= r.output_len <= o["max"] for r in reqs)
    assert all(a.due < b.due for a, b in zip(reqs, reqs[1:]))
    assert [r.index for r in reqs] == list(range(len(reqs)))
    assert len(reqs) == pytest.approx(MIX["rate"] * 45.0, rel=0.3)
    more = schedule(MIX, 45.0, rate=2 * MIX["rate"])
    assert len(more) == pytest.approx(2 * len(reqs), rel=0.3)


def test_tokens_are_deterministic_and_in_range():
    a, b = BigramTokens(500, 2**31 + 3), BigramTokens(500, 2**31 + 3)
    ba, bb = a.batch(4, 8, 33), b.batch(4, 8, 33)
    assert all(np.array_equal(ba[k], bb[k]) for k in ba)
    assert ba["tokens"].shape == (8, 33) and ba["tokens"].max() < 500
    assert np.array_equal(ba["tokens"][:, 1:], ba["labels"][:, :-1])
    assert not np.array_equal(ba["tokens"], a.batch(5, 8, 33)["tokens"])
    assert np.array_equal(a.prompt(7, 20), b.prompt(7, 20)) and a.prompt(7, 20).shape == (20,)
    assert not np.array_equal(a.prompt(7, 20), a.prompt(8, 20))


def test_successor_table_is_the_programs():
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticTokens

    ours = BigramTokens(300, 17)
    theirs = SyntheticTokens(SyntheticConfig(seq_len=8, batch_size=2, vocab_size=300, seed=17))
    assert np.array_equal(ours.successors, theirs.successors)


@pytest.mark.parametrize("name", ["dp4-ring", "dp4-nicfail"])
def test_training_mix_takes_fresh_rows_every_step(name):
    mix = harness.load("traffic", name)
    from r2bench.drivers.train import rank_rows

    tok = BigramTokens(1000, 3)
    small = dict(mix, seq_len=16)
    rows = [rank_rows(tok, small, s, r)[0] for s in range(3) for r in range(mix["ranks"])]
    flat = {tuple(row) for block in rows for row in block}
    assert len(flat) == 3 * mix["ranks"] * mix["rows_per_rank"]
    assert json.dumps(mix)            # plain data

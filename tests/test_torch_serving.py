"""The port's serving engine: the JAX package's serving cases run on the
port (glm4-smoke, weights converted from the JAX initialisation), and the
port held against the JAX engine under one deterministic fake clock."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.failures import Failure as JFailure
from repro.core.failures import FailureType as JFailureType
from repro.models import get_smoke_config as jax_smoke
from repro.models import init_model as jax_init_model
from repro.serving import ServingEngine as JServingEngine
from repro.serving import serve_trace as jax_serve_trace
from repro_torch.core.failures import Failure, FailureType
from repro_torch.models import get_smoke_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import Request, ServingEngine, serve_trace

STRATEGIES = ["r2ccl", "restart", "reroute", "dejavu"]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke("glm4-9b")
    jp = jax.jit(lambda key: jax_init_model(key, jcfg)[0])(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return get_smoke_config("glm4-9b"), tp, jcfg, jp


def _engine(setup, **kw):
    cfg, params, _, _ = setup
    return ServingEngine(cfg, params, context_len=64, device="cpu", **kw)


def _reqs(cfg, n=2, plen=12, new=6):
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, plen),
                    max_new_tokens=new) for _ in range(n)]


class FakeClock:
    """Deterministic host clock: every read advances by a fixed step."""

    def __init__(self, step=0.0125):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


# ---------------------------------------------------------------------------
# the JAX package's serving cases (tests/test_serving.py), on the port
# ---------------------------------------------------------------------------

def test_greedy_decode_deterministic(setup):
    cfg = setup[0]
    eng = _engine(setup, strategy="r2ccl")
    r1 = eng.run_batch(_reqs(cfg))
    r2 = eng.run_batch(_reqs(cfg))
    assert r1[0].tokens == r2[0].tokens
    assert len(r1[0].tokens) == 6


def test_r2ccl_continues_through_failure(setup):
    cfg = setup[0]
    fail = Failure(FailureType.NIC_HARDWARE, 0, 0)
    healthy = _engine(setup, strategy="r2ccl").run_batch(_reqs(cfg))
    failed = _engine(setup, strategy="r2ccl").run_batch(
        _reqs(cfg), fail_at_step=2, failure=fail)
    assert [r.tokens for r in healthy] == [r.tokens for r in failed]
    assert failed[0].failovers == 1


def test_restart_pays_full_penalty(setup):
    cfg = setup[0]
    fail = Failure(FailureType.NIC_HARDWARE, 0, 0)
    r_restart = _engine(setup, strategy="restart").run_batch(
        _reqs(cfg), fail_at_step=2, failure=fail)
    r_r2 = _engine(setup, strategy="r2ccl").run_batch(
        _reqs(cfg), fail_at_step=2, failure=fail)
    assert r_restart[0].total_latency > r_r2[0].total_latency + 30.0  # 35 s restart
    assert r_restart[0].tokens == r_r2[0].tokens


def test_unsupported_failure_rejected(setup):
    eng = _engine(setup, strategy="r2ccl")
    assert eng.inject_failure(Failure(FailureType.SWITCH_OUTAGE, 0, -1)) is False
    assert len(eng.failure_state.unsupported) == 1


def test_r2ccl_hiccup_is_control_plane_ledger(setup):
    cfg = setup[0]
    eng = _engine(setup, strategy="r2ccl")
    assert len(eng.control_plane.cluster.nodes) == 2    # pp=2 replica span
    res = eng.run_batch(_reqs(cfg), fail_at_step=2,
                        failure=Failure(FailureType.NIC_HARDWARE, 1, 0))
    assert res[0].failovers == 1
    assert eng.last_recovery is not None
    assert eng.last_recovery.total == sum(eng.last_recovery.stages.values())
    # out-of-replica node: constant-hiccup fallback, no crash
    eng2 = _engine(setup, strategy="r2ccl")
    res2 = eng2.run_batch(_reqs(cfg), fail_at_step=2,
                          failure=Failure(FailureType.NIC_HARDWARE, 5, 0))
    assert res2[0].failovers == 1
    assert eng2.last_recovery is None


def test_ttft_before_tpot(setup):
    res = _engine(setup, strategy="r2ccl").run_batch(_reqs(setup[0]))
    assert res[0].ttft > 0 and res[0].tpot > 0
    assert res[0].total_latency >= res[0].ttft


def test_serve_trace_failure_strategies_ordering(setup):
    """Under the same mid-trace failure, r2ccl's p95 TTFT beats restart's."""
    outs = {}
    for strat in ("r2ccl", "restart"):
        outs[strat] = serve_trace(
            _engine(setup, strategy=strat), qps=2.0, duration=3.0,
            prompt_len=12, max_new_tokens=4, fail_time=1.0,
            failure=Failure(FailureType.NIC_HARDWARE, 0, 0))
    assert outs["r2ccl"].completed >= 4
    assert outs["r2ccl"].ttft_p95 >= outs["r2ccl"].ttft_p50 > 0
    assert outs["r2ccl"].ttft_p95 < outs["restart"].ttft_p95
    assert outs["r2ccl"].failovers == 1


def test_hiccup_attribution_from_trace(setup):
    eng = _engine(setup, strategy="r2ccl")
    assert eng.hiccup_attribution() == {}
    eng.run_batch(_reqs(setup[0]), fail_at_step=2,
                  failure=Failure(FailureType.NIC_HARDWARE, 1, 0))
    attr = eng.hiccup_attribution()
    assert attr == pytest.approx(
        {k: v for k, v in eng.last_recovery.stages.items() if v > 0})
    frac = eng.hiccup_attribution(normalize=True)
    assert sum(frac.values()) == pytest.approx(1.0)
    assert max(frac, key=frac.get) == "diagnose"
    kinds = {r["type"] for r in eng.trace.records}
    assert {"failure", "stage", "transition"} <= kinds


def test_engine_needs_a_card_unless_cpu_is_asked(setup):
    cfg, params, _, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)


# ---------------------------------------------------------------------------
# the port against the JAX engine, one fake clock each
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_matches_jax_engine(setup, strategy):
    """Same tokens, failovers, virtual latencies, recovery ledger and trace
    records, exactly, under a NIC failure at decode step 2."""
    cfg, _, jcfg, jp = setup
    jeng = JServingEngine(jcfg, jp, context_len=64, strategy=strategy,
                          clock=FakeClock())
    teng = _engine(setup, strategy=strategy, clock=FakeClock())
    want = jeng.run_batch(_reqs(jcfg), fail_at_step=2,
                          failure=JFailure(JFailureType.NIC_HARDWARE, 1, 0))
    got = teng.run_batch(_reqs(cfg), fail_at_step=2,
                         failure=Failure(FailureType.NIC_HARDWARE, 1, 0))
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert teng.failovers == jeng.failovers == 1
    assert (teng.last_recovery is None) == (jeng.last_recovery is None)
    if jeng.last_recovery is not None:
        assert teng.last_recovery.stages == jeng.last_recovery.stages
        assert teng.last_recovery.total == jeng.last_recovery.total
    assert teng.trace.records == jeng.trace.records
    assert teng.hiccup_attribution() == jeng.hiccup_attribution()


def _check_engine_parity(arch, prompt_len):
    """``arch``'s smoke config through both engines under one fake clock:
    same tokens, virtual latencies, ledger and trace, with a NIC failure at
    decode step 2.  Returns the port's params and results."""
    jcfg = jax_smoke(arch)
    jp = jax.jit(lambda key: jax_init_model(key, jcfg)[0])(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jeng = JServingEngine(jcfg, jp, context_len=64, clock=FakeClock())
    teng = ServingEngine(get_smoke_config(arch), tp, context_len=64, device="cpu",
                         clock=FakeClock())
    want = jeng.run_batch(_reqs(jcfg, plen=prompt_len), fail_at_step=2,
                          failure=JFailure(JFailureType.NIC_HARDWARE, 1, 0))
    got = teng.run_batch(_reqs(jcfg, plen=prompt_len), fail_at_step=2,
                         failure=Failure(FailureType.NIC_HARDWARE, 1, 0))
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert got[0].failovers == 1 and len(got[0].tokens) == 6
    assert teng.last_recovery.stages == jeng.last_recovery.stages
    assert teng.trace.records == jeng.trace.records
    return tp, got


@pytest.mark.parametrize("arch,prompt_len", [("recurrentgemma-9b", 24), ("rwkv6-1.6b", 12)])
def test_recurrent_engine_matches_jax_engine(arch, prompt_len):
    """The recurrent families through both engines.  recurrentgemma-smoke's
    24-token prompts overrun its 16-slot local-attention window, so prefill
    wraps the ring buffer."""
    _check_engine_parity(arch, prompt_len)


@pytest.mark.parametrize("arch,prompt_len", [("gemma2-27b", 24), ("deepseek-67b", 12),
                                             ("dbrx-132b", 12)])
def test_gqa_engine_matches_jax_engine(arch, prompt_len):
    """Gemma-2's local/global pattern (24-token prompts wrap its 16-slot
    window), deepseek-67b and the MoE feed-forward of dbrx through both
    engines."""
    _check_engine_parity(arch, prompt_len)


def test_mla_engine_matches_jax_engine():
    """deepseek-v3-smoke through both engines: MLA's latent caches, the
    absorbed decode, MoE layers with a shared expert after one dense
    layer; the same tokens healthy (the run before the failure) and with
    the NIC failure."""
    tp, failed = _check_engine_parity("deepseek-v3-671b", 12)
    cfg = get_smoke_config("deepseek-v3-671b")
    healthy = ServingEngine(cfg, tp, context_len=64, device="cpu").run_batch(
        _reqs(cfg, plen=12))
    assert [r.tokens for r in healthy] == [r.tokens for r in failed]


def test_serve_trace_matches_jax(setup):
    cfg, _, jcfg, jp = setup
    kw = dict(qps=2.0, duration=2.0, prompt_len=12, max_new_tokens=4,
              fail_time=0.5)
    want = jax_serve_trace(
        JServingEngine(jcfg, jp, context_len=64, clock=FakeClock()),
        failure=JFailure(JFailureType.NIC_HARDWARE, 0, 0), **kw)
    got = serve_trace(_engine(setup, clock=FakeClock()),
                      failure=Failure(FailureType.NIC_HARDWARE, 0, 0), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu",
                    "--requests", "2", "--prompt-len", "12", "--max-new", "4",
                    "--fail-at-step", "1", "--fail-node", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert "failovers=1" in out[0]
    assert '"device": "cpu"' in out[-1]


def _serve_cli(arch, capsys):
    from repro_torch.launch import serve as serve_cli
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
                    "--prompt-len", "24", "--max-new", "4", "--fail-at-step", "1",
                    "--fail-node", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert "failovers=1" in out[0]
    assert '"device": "cpu"' in out[-1]


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_recurrent_serve_cli_on_cpu(arch, capsys):
    """``--arch`` takes the recurrent families; recurrentgemma-smoke's
    24-token prompts wrap its 16-slot window."""
    _serve_cli(arch, capsys)


@pytest.mark.parametrize("arch", ["gemma2-27b", "deepseek-67b", "dbrx-132b"])
def test_gqa_serve_cli_on_cpu(arch, capsys):
    """``--arch`` takes the other GQA families; gemma2-smoke's 24-token
    prompts wrap its 16-slot window."""
    _serve_cli(arch, capsys)


def test_mla_serve_cli_on_cpu(capsys):
    """``--arch deepseek-v3-671b`` serves MLA on the CPU (the MTP head is
    train-only and takes no part)."""
    _serve_cli("deepseek-v3-671b", capsys)

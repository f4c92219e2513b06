"""The port's model held against the JAX package's ``apply_model`` on five
dense, two MoE (one with MLA and the MTP head), two recurrent and the two
frontend (vision_text, audio_frames) smoke configs, from the same
(JAX-initialised) weights.  The prefill + decode check lives in
``_torch_model_parity.py`` (the frontends': ``test_torch_frontends.py``).

Tolerance: logits atol 3e-2, because the residual stream is bfloat16 in
both frameworks (``cfg.dtype``): a float32 sum taken in another order can
round the residual to the neighbouring bf16 value (~4e-3 relative), and
that propagates to the logits.

The reference runs op by op (``jax.disable_jit``), which is the semantics
of its code as written.  Compiled, XLA may keep excess precision across
fused bf16 converts, so the JAX package's compiled logits can differ from
its own op-by-op logits by more than this tolerance; the port follows the
op-by-op rounding points.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_model_parity import check_prefill_and_decode, converted_params
from repro.configs.base import FSDP_TP_RULES as J_FSDP_TP_RULES
from repro.configs.base import ShardingConfig as JShardingConfig
from repro.models import get_config as jax_get_config
from repro.models import get_smoke_config as jax_smoke
from repro.models.registry import ARCHITECTURES as JAX_ARCHITECTURES
from repro_torch.configs.base import AttentionConfig, FSDP_TP_RULES, MoEConfig, ShardingConfig
from repro_torch.data import make_batch
from repro_torch.kernels import ops
from repro_torch.models import (apply_model, get_config, get_smoke_config,
                                init_caches, init_model, list_architectures)

#: the fields the port's config dataclasses add past the JAX package's
PORT_ONLY = {"attention": ("latent_norms", "yarn"),
             "moe": ("scoring", "n_group", "topk_group", "routed_scaling_factor",
                     "held_experts")}
ARCHS = ["smollm-360m", "paper-7b", "glm4-9b", "recurrentgemma-9b", "rwkv6-1.6b",
         "gemma2-27b", "deepseek-67b", "dbrx-132b", "deepseek-v3-671b",
         "paligemma-3b", "hubert-xlarge"]


def test_prefill_and_decode_match_jax():
    """The other smoke configs: ``test_torch_model_parity.py``."""
    check_prefill_and_decode("smollm-360m")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return (request.param, *converted_params(request.param))


def test_params_layout_matches_jax(pair):
    """``params_from_jax`` keeps the pytree, and ``init_model`` builds the
    same structure, shapes and dtypes from a torch.Generator."""
    arch, cfg, jp, tp = pair
    own = init_model(get_smoke_config(arch), seed=0, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        node_t, node_o = tp, own
        for key in path:
            k = key.key if hasattr(key, "key") else key.idx
            node_t, node_o = node_t[k], node_o[k]
        assert tuple(node_t.shape) == tuple(node_o.shape) == leaf.shape
        assert node_o.dtype == torch.float32
        np.testing.assert_array_equal(node_t.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """Every field of the JAX package's configs is the port's, and every
    field the port adds past it (DeepSeek-V3 as published: the latent
    norms, YaRN, the sigmoid router, the held experts) sits at its default
    in every registry config, so each runs as the JAX package does."""
    def as_dict(c):
        d = dataclasses.asdict(c)
        d.pop("comm")          # CommConfig: compared field by field below
        return d

    def split(ours, theirs, path=()):
        """(the port's values at the JAX package's keys, the port-only
        fields with their paths)."""
        if not isinstance(ours, dict) or not isinstance(theirs, dict):
            return ours, {}
        same, extra = {}, {}
        for k, v in ours.items():
            if k in theirs:
                same[k], more = split(v, theirs[k], (*path, k))
                extra.update(more)
            else:
                extra[(*path, k)] = v
        return same, extra

    defaults = {(group, f.name): f.default
                for group, cls in (("attention", AttentionConfig), ("moe", MoEConfig))
                for f in dataclasses.fields(cls)}
    for ours, theirs in ((get_config(arch), jax_get_config(arch)),
                         (get_smoke_config(arch), jax_smoke(arch))):
        same, extra = split(as_dict(ours), as_dict(theirs))
        assert same == as_dict(theirs)
        assert set(extra) <= set(defaults), sorted(set(extra) - set(defaults))
        assert all(v == defaults[k] for k, v in extra.items()), extra
        for group, cls in (("attention", AttentionConfig), ("moe", MoEConfig)):
            if getattr(ours, group) is not None:
                assert {(group, f) for f in PORT_ONLY[group]} <= set(extra)
        assert dataclasses.asdict(ours.comm) == dataclasses.asdict(theirs.comm)
        assert ours.param_count() == theirs.param_count()
    # the logical-axis sharding rules (one copy each side, whatever the arch)
    assert dataclasses.asdict(ShardingConfig()) == dataclasses.asdict(JShardingConfig())
    assert ShardingConfig().lookup() == JShardingConfig().lookup()
    assert FSDP_TP_RULES == J_FSDP_TP_RULES


def test_registry_and_device_rules():
    """Every architecture of the JAX package is registered in the port, and
    its full and smoke configs resolve."""
    assert list_architectures() == sorted(JAX_ARCHITECTURES) == sorted(ARCHS)
    for arch in list_architectures():
        assert get_config(arch).name == arch
        assert (dataclasses.asdict(get_smoke_config(arch).modality)
                == dataclasses.asdict(jax_smoke(arch).modality))
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_model(get_smoke_config("smollm-360m"))
    with pytest.raises(ValueError, match="mode"):
        apply_model({}, get_smoke_config("smollm-360m"),
                    {"tokens": torch.zeros(1, 2, dtype=torch.long)}, mode="bogus")
    with pytest.raises(ValueError, match="caches"):
        apply_model({}, get_smoke_config("smollm-360m"),
                    {"tokens": torch.zeros(1, 2, dtype=torch.long)}, mode="prefill")


def test_attn_impl_reference_equals_auto_on_cpu(pair):
    """``ops.use("reference")`` (the plain version of every kernel) is the
    CPU path itself: prefill for the decoders (paligemma's over its image
    prefix and 7 text tokens), train mode for the encoder."""
    arch, cfg, _, tp = pair
    tcfg = get_smoke_config(arch)
    ctx = 8
    if cfg.modality.kind == "text":
        batch = {"tokens": torch.from_numpy(
            np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 7)))}
    else:
        P = cfg.modality.num_prefix_tokens
        batch = {k: torch.from_numpy(v)
                 for k, v in make_batch(tcfg, seq_len=P + 7, batch_size=1, step=1).items()}
        ctx = P + 8
    mode = "train" if cfg.encoder_only else "prefill"

    def run(impl):
        caches = None if cfg.encoder_only else init_caches(tcfg, 1, ctx, device="cpu")
        with ops.use(impl):
            return apply_model(tp, tcfg, batch, mode=mode, caches=caches)[0]
    torch.testing.assert_close(run("auto"), run("reference"), rtol=0, atol=0)

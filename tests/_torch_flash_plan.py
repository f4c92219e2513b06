"""The forward kernel's walk over the key tiles (``fwd_plan``) and the
backward kernel's work split (``bwd_plan``) held to the mask: shared by the
flash-attention and MLA tests."""

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (BWD_KEYS, BWD_ROWS, bwd_plan, fwd_plan,
                                                 fwd_tiles)


def check_forward_plan(tq: int, tk: int, G: int, D: int, kw: dict) -> None:
    """``fwd_plan``'s CTAs meet every (query row, key) pair that
    ``ref.attention_mask`` leaves visible exactly once, a warp skips a key
    tile only where none of its pairs is visible, and the mask is left out
    only where every pair of the block is visible."""
    kw = dict(kw)
    plan = fwd_plan(tq, tk, G, D, **kw)
    assert (plan.rows, plan.keys) == fwd_tiles(D)
    q_off = kw.pop("q_offset", 0)
    mask = ref.attention_mask(q_off + torch.arange(tq), torch.arange(tk),
                              causal=kw.get("causal", True), window=kw.get("window"),
                              prefix_len=kw.get("prefix_len"),
                              k_valid_len=kw.get("k_valid_len"), k_len=tk).numpy()
    visible = np.repeat(np.broadcast_to(mask, (tq, tk)), G, axis=0)   # row t * G + g -> position t
    nr = tq * G
    seen = np.zeros((nr, tk), np.int64)
    assert sorted(qt for qt, _, _ in plan.ctas) == list(range(-(-nr // plan.rows)))
    for qt, first, classes in plan.ctas:
        for i, per_warp in enumerate(classes):
            k0 = (first + i) * plan.keys
            assert len(per_warp) == plan.rows // 16
            for w, cls in enumerate(per_warp):
                r0 = qt * plan.rows + 16 * w
                block = visible[r0:r0 + 16, k0:k0 + plan.keys]
                if cls == "skip":
                    assert not block.any()
                    continue
                if cls == "full":
                    assert block.all() and block.shape[1] == plan.keys
                seen[r0:r0 + 16, k0:k0 + plan.keys] += 1
    assert (seen[visible] == 1).all()
    assert seen.max() <= 1


def check_backward_plan(tq: int, tk: int, G: int, D: int, dtype: torch.dtype,
                        n_sm: int, kw: dict):
    """``bwd_plan``'s dK/dV CTAs and, separately, its dQ CTAs meet every
    (query row, key) pair that ``ref.attention_mask`` leaves visible exactly
    once; cluster sizes are 1 to 8.  Returns the plan."""
    plan = bwd_plan(2, tq, tk, 5, G, D, dtype=dtype, n_sm=n_sm, **kw)
    mask = ref.attention_mask(torch.arange(tq), torch.arange(tk), causal=kw.get("causal", True),
                              window=kw.get("window"), prefix_len=kw.get("prefix_len"),
                              k_valid_len=None, k_len=tk).numpy()
    visible = np.repeat(np.broadcast_to(mask, (tq, tk)), G, axis=0)   # row t * G + g -> position t
    nr = tq * G
    assert plan.split_dkdv in (1, 2, 4, 8) and plan.split_dq in (1, 2, 4, 8)
    assert len(plan.dkdv) == -(-tk // BWD_KEYS) * plan.split_dkdv
    assert len(plan.dq) == -(-nr // BWD_ROWS) * plan.split_dq
    seen = np.zeros((nr, tk), np.int64)
    for kt, rank, first, end in plan.dkdv:
        assert 0 <= rank < plan.split_dkdv and 0 <= first <= end
        seen[first:min(end, nr), kt * BWD_KEYS:(kt + 1) * BWD_KEYS] += 1
    assert (seen[visible] == 1).all()
    seen[:] = 0
    for qt, rank, lo, hi in plan.dq:
        assert 0 <= rank < plan.split_dq and 0 <= lo <= hi
        seen[qt * BWD_ROWS:(qt + 1) * BWD_ROWS, lo:hi] += 1
    assert (seen[visible] == 1).all()
    return plan

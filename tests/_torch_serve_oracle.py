"""The serving engine's plain oracle: the batch left-padded to its longest
prompt, one prefill and greedy decode steps over fresh caches of exactly
its rows, each an eager ``apply_model`` call.  No static buffers, no
capture, no padded rows: what ``ServingEngine.run_batch``'s tokens should
be.  Imports no JAX.
"""

import numpy as np
import torch

from repro_torch.models import apply_model, init_caches


@torch.no_grad()
def plain_tokens(cfg, params, requests, *, context_len: int,
                 cache_dtype=torch.float32, device="cpu") -> list[list[int]]:
    """Each request's tokens, as ``RequestResult.tokens``."""
    B = len(requests)
    T = max(len(r.prompt) for r in requests)
    toks = np.zeros((B, T), np.int64)
    for i, r in enumerate(requests):
        toks[i, T - len(r.prompt):] = r.prompt
    caches = init_caches(cfg, B, context_len, dtype=cache_dtype, device=device,
                         device_index=True)
    logits, caches, _ = apply_model(params, cfg, {"tokens": torch.as_tensor(toks, device=device)},
                                    mode="prefill", caches=caches)
    tok = logits[:, -1].argmax(-1)
    out = [[t] for t in tok.tolist()]
    for _ in range(max(r.max_new_tokens for r in requests) - 1):
        logits, caches, _ = apply_model(params, cfg, {"tokens": tok[:, None]}, mode="decode",
                                        caches=caches)
        tok = logits[:, -1].argmax(-1)
        for row, t in zip(out, tok.tolist()):
            row.append(t)
    return [row[:r.max_new_tokens] for row, r in zip(out, requests)]

"""Hand-written Hopper (sm_90a) kernels for the port's compute layers.

  flash_attention     — online-softmax GQA attention, full mask menu (causal /
                        sliding-window / prefix-LM / logit softcap / q offset /
                        cache fill level), CUDA C++ in ``csrc/``; optionally
                        writes the row log-sum-exp for the backward
  flash_attention_bwd — its gradient (dq, dk, dv) over the training mask menu,
                        joined to the forward as an ``autograd.Function``
  chunk_combine       — the R2CCL stage-2 merge of a round's received chunks
                        into the local buffer (select / accumulate per row)
  lru_scan            — the RG-LRU recurrence h_t = a_t h_{t-1} + x_t from a
                        starting state (RecurrentGemma prefill)
  wkv_scan            — the RWKV-6 WKV recurrence with its matrix state, from
                        a starting state, also returning the final state
  small_mm            — float32 products at 1-16 rows (decode's), streaming
                        the weights once; no TPU counterpart (XLA's dot)

Each kernel has a ctypes wrapper that checks its inputs and counts its
launches, a plain PyTorch version in ``ref.py``, and dispatch by device in
``ops.py``.  Kernels are built with ``nvcc`` at first use (``build.py``).
"""

from . import ops, ref  # noqa: F401

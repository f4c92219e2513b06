"""PyTorch/CUDA port of the R2CCL reproduction, for NVIDIA Hopper (H100).

Mirrors the layout of the JAX package ``repro`` (``configs``, ``core``,
``runtime``, ``kernels``, ``models``, ``serving``, ``launch``, ``optim``,
``training``, ``data``, ``analysis``) so each module
has an obvious counterpart, but imports nothing of it: the framework-free
modules it needs are its own copies.  Entry points take ``device=`` and run
on the card (``"cuda"``) unless the caller asks for the CPU.
"""

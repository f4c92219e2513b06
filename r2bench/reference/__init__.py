"""The plain reference: a llama-architecture model, its training steps and
the gaps of served tokens, in plain PyTorch.  Imports nothing of the program
(``repro_torch``), of JAX or of the JAX package."""

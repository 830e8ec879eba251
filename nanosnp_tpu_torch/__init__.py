"""NanoSNP on PyTorch and CUDA for an NVIDIA H100.

A port of the JAX package `nanosnp_tpu`, which stays beside it as the
reference. This package imports torch and never jax, and nothing of
`nanosnp_tpu`. Its BiLSTM kernels are hand-written CUDA for sm_90a
(ops/csrc), built at first use; importing the package builds nothing.
Entry points run on the card unless the caller passes device="cpu".
"""

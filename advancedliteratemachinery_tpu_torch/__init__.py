"""PyTorch/CUDA port of `advancedliteratemachinery_tpu` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here mirrors
the module of the same path there and is held against it by the
`tests/test_torch_*.py` parity tests. Pallas kernels become hand-written CUDA
kernels under `csrc/`, built on first use by `ops/_kernels.py`; each keeps a
plain PyTorch version beside it that runs for CPU tensors only.

The port imports torch, numpy and the standard library, never JAX or the JAX
package.
"""

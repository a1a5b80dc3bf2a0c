"""tendermint_tpu_torch — commit-signature verification and block-sync
replay on PyTorch and CUDA.

The PyTorch/CUDA counterpart of `tendermint_tpu`, module for module
(`crypto/tpu/` becomes `crypto/cuda/`). The device path runs the
range-batched ed25519 batch equation on an NVIDIA Hopper card, with the
field multiply, the pow22523 exponentiation chain and the MSM's blocked
prefix scan as hand-written CUDA kernels (crypto/cuda/csrc/); the
block-sync reactor sends it one range of commits per window and applies
the blocks through the kvstore app (blocksync/, state/, store/, abci/).

Entry points take `device=` and default to "cuda"; without a card they
raise unless the caller passes device="cpu", which runs every kernel's
plain PyTorch version instead. Importing the package needs neither CUDA
nor nvcc: kernels are compiled at their first launch.
"""

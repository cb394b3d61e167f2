"""sunerf_tpu_torch — the PyTorch / CUDA port of sunerf_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths. The serving path (render a trained
deployment bundle) runs here; the fused field forward runs as a hand-written
CUDA kernel on the card (ops/fused_mlp.py, csrc/fused_mlp_fwd.cu) and as its
plain PyTorch version on CPU tensors. Imports torch, numpy and the standard
library only.
"""

"""sunerf_tpu_torch — the PyTorch / CUDA port of sunerf_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths. The emission head serves (render a
trained deployment bundle) and trains: run_emission.py drives the host data
layer (data/, native/) and the Trainer (train/loop.py) over the train step
(train/step.py). The fused field runs as hand-written CUDA kernels on the
card (ops/fused_mlp.py, csrc/: the forward, and the stashing forward and
backward behind one autograd Function; a field of a width the kernels are
not built for runs zero-padded to the next) and as their plain PyTorch
versions on CPU tensors. Imports torch, numpy and the standard library only.
"""

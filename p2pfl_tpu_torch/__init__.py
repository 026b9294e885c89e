"""p2pfl_tpu_torch: the PyTorch/CUDA port of p2pfl_tpu for NVIDIA Hopper.

A second package beside ``p2pfl_tpu`` (the JAX reference, which it never
imports). Same layout and module names; the federation's nodes are an
explicit leading ``[n]`` axis on every tensor, and the Pallas kernels of
the training path are hand-written CUDA kernels for ``sm_90a`` (see
``ops/gemm.py``). Entry points run on the card unless the caller asks
for the CPU.
"""

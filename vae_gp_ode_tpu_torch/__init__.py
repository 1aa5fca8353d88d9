"""PyTorch/CUDA port of the VAE-GP-ODE framework.

A second package beside the JAX reference `vae_gp_ode_tpu`: the same
modules under the same paths and names, in PyTorch, with every Pallas
kernel of the ported path replaced by a CUDA kernel written for Hopper
(`csrc/`, built with nvcc into a plain-C shared library and bound with
ctypes, see `ops/_build.py`).

The package imports torch, numpy and (for the data) scipy - never jax,
flax or the JAX package - so it runs on a machine with no JAX
installed. Entry points run on the GPU unless the caller asks for the
CPU (`device='cpu'`), where every kernel wrapper computes its plain
PyTorch version instead.
"""

__version__ = "0.1.0"

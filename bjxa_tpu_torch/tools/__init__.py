"""Probes of the PyTorch/CUDA port, one module per script of the JAX
package's ``tools/`` directory that it has a counterpart for."""

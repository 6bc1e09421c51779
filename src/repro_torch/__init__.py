"""PyTorch/CUDA port of the MENAGE software twin.

The same mapped model, control memories and bit-exact engine as the JAX
package, with the Pallas kernels of its serving path replaced by CUDA C++
kernels written for Hopper (``kernels/csrc``).  Entry points run on the card unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper uses its plain
PyTorch version.
"""

"""PyTorch/CUDA port of the batched SMPLify-X fitter.

A package of its own beside `smplifyx_tpu` (the JAX reference), with the
same module layout.  It imports torch, numpy and yaml only.  Entry points
take `device=` (default "cuda") and raise when no card is present unless
the caller asks for the CPU.
"""

__version__ = "0.1.0"

"""ngp_tpu — a JAX neural graphics primitives framework.

A from-scratch JAX/XLA/Pallas implementation of the capabilities of
instant-ngp (reference: yblin/instant-ngp): NeRF, SDF, 2D image fitting and
volume rendering, all built on a multiresolution hash-grid encoding plus tiny
MLPs, designed for XLA (static shapes, masked marching, batched bf16
matmuls, SPMD sharding over device meshes).
"""

__version__ = "0.1.0"

"""Hand-written Hopper kernels (``csrc/*.cu``), their plain PyTorch
versions, and the device dispatch between them (``ops``)."""

"""Hand-written Hopper kernels (``csrc/*.cu``), their plain PyTorch versions
(``ref.py``) and the device dispatch (``ops.py``)."""

"""Hand-written CUDA kernels for the query path (``csrc/``), with their
plain PyTorch versions in ref.py and device dispatch in ops.py."""

"""repro_torch — the PyTorch/CUDA port of ``repro``'s Hybrid LSH index.

The package mirrors ``repro``'s layout module for module and is held
against it by the ``tests/test_torch_*.py`` parity tests.  It imports
``torch`` and numpy only.  Its entry points run on the GPU
(``device="cuda"``) unless the caller asks for the CPU, where every
kernel wrapper runs its plain PyTorch version.

float32 matrix products are pinned to IEEE float32 here, once: the
SimHash and p-stable codes are signs and floors of ``x @ R`` products,
and TF32's 10-bit mantissa would flip codes near 0 and move distances
near the report radius.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

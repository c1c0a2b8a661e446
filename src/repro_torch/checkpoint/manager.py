"""Content addresses of stored arrays.

``array_digest`` hashes an array as numpy holds it: a tensor is taken
to the host with ``.cpu().numpy()`` first, so the dtype string and the
bytes are numpy's and an equal array gets the same digest as in
``repro.checkpoint.manager``.  The chunk store, the manifests and the
incremental saves are not ported yet.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

__all__ = ["array_digest"]


def array_digest(arr) -> str:
    """Content address of one stored leaf: blake2b over dtype + shape +
    raw bytes.  bfloat16 hashes as its stored uint16 view so the digest
    always matches the bytes on disk."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            arr = arr.view(torch.int16).cpu().numpy().view(np.uint16)
        else:
            arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr)
    if str(arr.dtype) == "bfloat16":
        arr = arr.view(np.uint16)
    h = hashlib.blake2b(digest_size=16)
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()

"""Array (de)serialization for the two-terminal RPC boundary.

Port of ``m3p2i_aip_tpu/utils/data_transfer.py`` with the same wire format,
byte for byte: ``numpy.save`` bytes, no pickle, so a client of the JAX
package and a server of this one understand each other.  Tensors go over
the wire through the host; device placement happens on the receiving side
(:func:`bytes_to_tensor`).
"""
from __future__ import annotations

import io

import numpy as np
import torch


def array_to_bytes(x) -> bytes:
    """Serialize a numpy array or a tensor (on any device)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    buf = io.BytesIO()
    np.save(buf, np.asarray(x), allow_pickle=False)
    return buf.getvalue()


def bytes_to_numpy(b: bytes) -> np.ndarray:
    return np.load(io.BytesIO(b), allow_pickle=False)


def bytes_to_tensor(b: bytes, device) -> torch.Tensor:
    """Deserialize onto ``device``."""
    return torch.as_tensor(bytes_to_numpy(b), device=device)

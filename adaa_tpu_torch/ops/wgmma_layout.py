"""The shared-memory image of a wgmma B operand, built on the host.

``csrc/hopper.cuh`` reads a K-major bf16 B operand of n rows from boxes
of n rows x 64 k (128 bytes a row) with the 128-byte swizzle: the
16-byte chunk c of row r sits at chunk c ^ (r % 8). The kernels that
keep their weights resident in shared memory (``csrc/trunk.cu``,
``csrc/layer0.cu``) copy such an image in as it is; these functions
make it and take it apart.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BOX_K = 64  # k values per 128-byte swizzled row of a packed operand


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def operand_bytes(n: int, k: int) -> int:
    """Bytes of a packed (n, k) bf16 B operand: 128-byte rows, k padded to 64."""
    return cdiv(k, BOX_K) * n * 128


def _chunk_index(boxes: int, n: int, device) -> torch.Tensor:
    chunk = torch.arange(8)[None, :] ^ (torch.arange(n)[:, None] % 8)  # (n, 8)
    return chunk[None, :, :, None].expand(boxes, n, 8, 8).to(device)


def swizzle_operand(b: torch.Tensor) -> torch.Tensor:
    """(n, k) -> the flat shared-memory image wgmma reads as a K-major B
    operand: k padded to a multiple of 64, boxes of n rows x 64 k, the
    16-byte chunk c of row r at chunk c ^ (r % 8)."""
    n, k = b.shape
    kp = cdiv(k, BOX_K) * BOX_K
    b = F.pad(b, (0, kp - k)).reshape(n, kp // BOX_K, 8, 8).permute(1, 0, 2, 3)
    return torch.gather(b, 2, _chunk_index(b.shape[0], n, b.device)).contiguous().reshape(-1)


def unswizzle_operand(img: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The inverse of ``swizzle_operand``: -> (n, k)."""
    kp = cdiv(k, BOX_K) * BOX_K
    b = img.reshape(kp // BOX_K, n, 8, 8)
    b = torch.gather(b, 2, _chunk_index(b.shape[0], n, b.device))
    return b.permute(1, 0, 2, 3).reshape(n, kp)[:, :k]

"""Segmentation overlays as PNG files (counterpart of
`xlstm_hved_tpu/utils/visualize.py`), in the port's channel-first layout.

The PNG is written here from `zlib` and `struct` (8-bit RGB, one IDAT chunk,
no interlace, filter 0 on every row), so the export needs no imaging
package; its pixels are those the JAX function writes through PIL.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

# WT / TC / ET overlay colours (RGB)
_COLORS = np.asarray([[66, 135, 245], [245, 197, 66], [245, 66, 66]], np.float32)
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _to_uint8(img: np.ndarray) -> np.ndarray:
    lo, hi = float(img.min()), float(img.max())
    if hi <= lo:
        return np.zeros_like(img, np.uint8)
    return ((img - lo) / (hi - lo) * 255).astype(np.uint8)


def segmentation_overlay(image: np.ndarray, mask: np.ndarray,
                         alpha: float = 0.45) -> np.ndarray:
    """image (H, W), mask (3, H, W) nested WT/TC/ET -> RGB uint8 (H, W, 3)."""
    base = _to_uint8(image)
    rgb = np.stack([base] * 3, axis=-1).astype(np.float32)
    for c in range(3):
        sel = mask[c] > 0.5
        rgb[sel] = (1 - alpha) * rgb[sel] + alpha * _COLORS[c]
    return rgb.astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8; got {rgb.shape}")
    height, width, _ = rgb.shape
    # each scanline is preceded by its filter type, 0 (none)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rgb.reshape(height, -1)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def plot_segm(out_dir: str, name: str, image: np.ndarray, pred: np.ndarray,
              target: Optional[np.ndarray] = None,
              slices: Optional[Sequence[int]] = None) -> List[str]:
    """Axial slice overlays, the prediction beside the target. image
    (D, H, W) or (C, D, H, W) (channel 0 used); pred / target (3, D, H, W).
    Writes <out_dir>/<name>_z<slice>.png for slices D/4, D/2, 3D/4 by
    default; returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    if image.ndim == 4:
        image = image[0]
    depth = image.shape[0]
    if slices is None:
        slices = [depth // 4, depth // 2, 3 * depth // 4]
    paths = []
    for s in slices:
        panels = [segmentation_overlay(image[s], pred[:, s])]
        if target is not None:
            panels.append(segmentation_overlay(image[s], target[:, s]))
        path = os.path.join(out_dir, f"{name}_z{s}.png")
        write_png(path, np.concatenate(panels, axis=1))
        paths.append(path)
    return paths

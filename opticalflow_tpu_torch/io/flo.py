"""Middlebury ``.flo`` flow-file I/O.

Behavioral clone of the reference writer/reader (``script_pwc.py:12-27``,
``pwc_extract_flow.py:46-56``, ``data_processing.py:17-29``): float32 magic
tag 202021.25, int32 width, int32 height, then row-major interleaved (u, v)
float32 — bit-compatible with the reference output (part of the public CLI
contract).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["read_flo", "write_flo", "write_flo_bytes", "TAG_FLOAT"]

TAG_FLOAT = 202021.25


def write_flo_bytes(flow_uv: np.ndarray) -> bytes:
    """Serialize (H, W, 2) float32 flow to Middlebury .flo bytes."""
    flow_uv = np.asarray(flow_uv)
    if flow_uv.ndim != 3 or flow_uv.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow_uv.shape}")
    h, w, _ = flow_uv.shape
    return (struct.pack("<f", TAG_FLOAT) + struct.pack("<i", w)
            + struct.pack("<i", h) + flow_uv.astype("<f4").tobytes())


def write_flo(path: str, flow_uv: np.ndarray) -> None:
    """Write (H, W, 2) float32 flow to a Middlebury .flo file."""
    with open(path, "wb") as f:
        f.write(write_flo_bytes(flow_uv))


def read_flo(path: str) -> np.ndarray:
    """Read a Middlebury .flo file into (H, W, 2) float32.

    Fails loudly with the path and the specific defect on malformed input
    (short/missing header, wrong magic, nonsensical dimensions, truncated
    payload) — the reference readers raise bare struct/reshape errors here
    (``data_processing.py:17-29``).
    """
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12:
            raise ValueError(f"{path}: not a .flo file (only {len(header)} "
                             f"header bytes, expected 12)")
        tag = struct.unpack("<f", header[:4])[0]
        if abs(tag - TAG_FLOAT) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {tag!r}")
        w, h = struct.unpack("<ii", header[4:12])
        if not (0 < w < 10**6 and 0 < h < 10**6):
            raise ValueError(f"{path}: implausible .flo dimensions "
                             f"{w}x{h}")
        raw = f.read(h * w * 2 * 4)
    if len(raw) != h * w * 2 * 4:
        # length check BEFORE frombuffer: a payload truncated off a 4-byte
        # boundary would otherwise raise numpy's bare "buffer size must be
        # a multiple of element size" with no path
        raise ValueError(f"{path}: truncated .flo ({len(raw)} payload "
                         f"bytes, expected {h * w * 2 * 4})")
    data = np.frombuffer(raw, dtype="<f4")
    return data.reshape(h, w, 2).copy()

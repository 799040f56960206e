"""Minimal STL mesh IO in pure numpy, the port's copy of
``gelslim_depth_tpu/meshgen/stl.py`` (the same bytes in and out).

Replaces the reference's Open3D C++ dependency for mesh reading
(ref gelslim_depth/mesh_utils/depth_from_mesh.py:55-56). STL is trivial:

binary: 80-byte header, uint32 triangle count, then per-triangle
        12 little-endian float32 (normal + 3 vertices) + uint16 attribute.
ascii:  'solid ...' with 'facet normal' / 'vertex' records.
"""

from __future__ import annotations

import struct

import numpy as np


def load_stl(path: str) -> np.ndarray:
    """Returns triangles as a (T, 3, 3) float32 vertex array."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        data = f.read()
    if head[:5].lower() == b"solid" and b"facet" in data[:1000]:
        try:
            return _parse_ascii(data.decode("ascii", errors="ignore"))
        except Exception:
            pass  # 'solid'-prefixed binary files exist in the wild
    return _parse_binary(data)


def _parse_binary(data: bytes) -> np.ndarray:
    n = struct.unpack_from("<I", data, 80)[0]
    rec = np.frombuffer(data, dtype=np.uint8, count=n * 50, offset=84).reshape(n, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(n, 4, 3)
    return np.ascontiguousarray(floats[:, 1:4], dtype=np.float32)  # drop normals


def _parse_ascii(text: str) -> np.ndarray:
    verts = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    arr = np.asarray(verts, np.float32)
    if arr.size == 0 or arr.shape[0] % 3:
        raise ValueError("malformed ascii STL")
    return arr.reshape(-1, 3, 3)


def save_stl_binary(path: str, triangles: np.ndarray) -> None:
    """(T, 3, 3) vertices -> binary STL (normals recomputed)."""
    tri = np.asarray(triangles, np.float32)
    n = tri.shape[0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    nrm = np.cross(e1, e2)
    lens = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / np.maximum(lens, 1e-12)
    rec = np.zeros((n, 50), np.uint8)
    block = np.concatenate([nrm[:, None, :], tri], axis=1).astype("<f4").reshape(n, 48 // 4)
    rec[:, :48] = block.view(np.uint8).reshape(n, 48)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", n))
        f.write(rec.tobytes())

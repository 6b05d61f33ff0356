"""STL reader, binary and ASCII, NumPy only (a copy of tpu3dm/io/stl.py).

Loads an STL mesh and exposes its unique vertices as a point cloud: the
reference's converter (trimesh) merges duplicate vertices on load, matched
here by a unique-row reduction.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class StlError(ValueError):
    pass


def read_stl(path: str | Path) -> dict[str, np.ndarray]:
    """Read an STL file.

    Returns ``{"vertices": [V, 3] float64 unique vertices,
               "triangles": [T, 3] int32 indices into vertices,
               "facet_normals": [T, 3] float64}``.
    """
    path = Path(path)
    raw = path.read_bytes()
    if len(raw) < 15:
        raise StlError(f"File too small to be STL: {path}")
    # ASCII STLs begin with 'solid'; some binary exporters do too, so a file
    # that starts with 'solid' is binary only if it meets the binary size
    # equation.
    is_binary = True
    if raw[:5].lower() == b"solid":
        if len(raw) >= 84:
            (ntri,) = np.frombuffer(raw[80:84], dtype="<u4")
            if len(raw) != 84 + 50 * int(ntri):
                is_binary = False
        else:
            is_binary = False

    if is_binary:
        (ntri,) = np.frombuffer(raw[80:84], dtype="<u4")
        ntri = int(ntri)
        if len(raw) < 84 + 50 * ntri:
            raise StlError(f"Truncated binary STL: {path}")
        rec = np.frombuffer(
            raw[84: 84 + 50 * ntri],
            dtype=np.dtype([("normal", "<f4", 3), ("verts", "<f4", (3, 3)), ("attr", "<u2")]),
        )
        tris = rec["verts"].astype(np.float64)  # [T, 3, 3]
        normals = rec["normal"].astype(np.float64)
    else:
        tris, normals = _parse_ascii(raw.decode("ascii", errors="replace"))

    if tris.shape[0] == 0:
        raise StlError(f"STL has no facets: {path}")
    vertices, inverse = np.unique(tris.reshape(-1, 3), axis=0, return_inverse=True)
    triangles = inverse.reshape(-1, 3).astype(np.int32)
    return {"vertices": vertices, "triangles": triangles, "facet_normals": normals}


def _parse_ascii(text: str) -> tuple[np.ndarray, np.ndarray]:
    verts: list[list[float]] = []
    normals: list[list[float]] = []
    for line in text.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "vertex":
            verts.append([float(tok[1]), float(tok[2]), float(tok[3])])
        elif tok[0] == "facet" and len(tok) >= 5 and tok[1] == "normal":
            normals.append([float(tok[2]), float(tok[3]), float(tok[4])])
    if len(verts) % 3 != 0:
        raise StlError("ASCII STL vertex count not a multiple of 3")
    tris = np.asarray(verts, dtype=np.float64).reshape(-1, 3, 3)
    nrm = (np.asarray(normals, dtype=np.float64) if len(normals) == tris.shape[0]
           else np.zeros((tris.shape[0], 3)))
    return tris, nrm


def stl_to_point_cloud(path: str | Path) -> np.ndarray:
    """An STL's unique vertices as a [V, 3] point cloud."""
    return read_stl(path)["vertices"]

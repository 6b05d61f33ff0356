"""PLY reader and writer (port of tpu3dm/io/ply.py): ASCII and binary,
little- and big-endian, NumPy only.

The reader takes a file's ``vertex`` element (positions, and normals and
colours where present) and skips other elements such as faces.  ASCII
payloads with scalar properties only are one flat stream of numbers, parsed
by ``csrc/host.cpp``'s ``t3n_parse_floats`` (the JAX package's native parser,
copied); files with list properties go through Python tokens, as JAX's
reader does.  The formats' semantics are JAX's: an empty cloud raises
``ValueError``, a malformed file ``PlyError``, ``uchar`` colours are scaled
to [0, 1], and the writer writes float64 fields and ``uchar`` colours.
"""

from __future__ import annotations

import ctypes
import io as _io
from pathlib import Path

import numpy as np

from tpu3dm_torch.csrc import host_library

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


class PlyError(ValueError):
    pass


def _parse_header(f) -> tuple[str, list[tuple[str, int, list[tuple[str, str]]]], int]:
    """Parse a PLY header.

    Returns (format, elements, header_len) where elements is a list of
    (name, count, [(prop_name, np_dtype_char)...]).  List properties are
    recorded with dtype 'LIST:<count_t>:<item_t>'.
    """
    magic = f.readline()
    if magic.strip() != b"ply":
        raise PlyError("Not a PLY file (missing 'ply' magic)")
    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    while True:
        line = f.readline()
        if not line:
            raise PlyError("Unexpected EOF in PLY header")
        tok = line.decode("ascii", errors="replace").strip().split()
        if not tok or tok[0] == "comment" or tok[0] == "obj_info":
            continue
        if tok[0] == "format":
            fmt = tok[1]  # ascii | binary_little_endian | binary_big_endian
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if not elements:
                raise PlyError("property before element in header")
            if tok[1] == "list":
                elements[-1][2].append(
                    (tok[4], f"LIST:{_PLY_TO_NP[tok[2]]}:{_PLY_TO_NP[tok[3]]}")
                )
            else:
                elements[-1][2].append((tok[2], _PLY_TO_NP[tok[1]]))
        elif tok[0] == "end_header":
            break
        else:
            raise PlyError(f"Unknown header line: {line!r}")
    if fmt is None:
        raise PlyError("PLY header missing 'format' line")
    return fmt, elements, f.tell()


def read_ply(path: str | Path) -> dict[str, np.ndarray]:
    """Read a PLY file's vertex element.

    Returns a dict with ``points [N,3] float64`` and, when present,
    ``normals [N,3]`` and ``colors [N,3] float64 in [0,1]``.
    Raises PlyError on malformed files and ValueError on empty clouds.
    """
    path = Path(path)
    with open(path, "rb") as f:
        fmt, elements, _ = _parse_header(f)
        vertex = next((e for e in elements if e[0] == "vertex"), None)
        if vertex is None:
            raise PlyError(f"No vertex element in {path}")
        _, count, props = vertex
        if any(d.startswith("LIST") for _, d in props):
            raise PlyError("list property on vertex element unsupported")

        if fmt == "ascii":
            data = _read_ascii_elements(f, elements)
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            data = _read_binary_elements(f, elements, endian)
        varr = data["vertex"]

    names = [n for n, _ in props]

    def grab(cols: tuple[str, str, str]) -> np.ndarray | None:
        if all(c in names for c in cols):
            return np.stack([varr[c].astype(np.float64) for c in cols], axis=1)
        return None

    points = grab(("x", "y", "z"))
    if points is None:
        raise PlyError(f"vertex element lacks x/y/z in {path}")
    if len(points) == 0:
        raise ValueError(f"Point cloud is empty: {path}")
    out = {"points": points}
    normals = grab(("nx", "ny", "nz"))
    if normals is not None:
        out["normals"] = normals
    colors = grab(("red", "green", "blue"))
    if colors is not None:
        if varr["red"].dtype == np.uint8:
            colors = colors / 255.0
        out["colors"] = colors
    return out


def parse_floats(buf: bytes, expected: int) -> np.ndarray:
    """``expected`` whitespace-separated numbers of ``buf`` (host.cpp's
    ``t3n_parse_floats``).  ``buf`` must be a ``bytes`` object: its NUL
    terminator is what stops ``strtod`` at the end of the buffer.  Raises
    ValueError on a malformed token or any other count."""
    if not isinstance(buf, bytes):
        raise TypeError(f"parse_floats needs bytes, got {type(buf).__name__}")
    out = np.empty(expected, dtype=np.float64)
    got = host_library().t3n_parse_floats(
        buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), expected
    )
    if got < 0:
        raise ValueError("malformed numeric token in ASCII payload")
    if got != expected:
        raise ValueError(f"expected {expected} numbers, parsed {got}")
    return out


def _read_ascii_elements(f, elements):
    raw = f.read()

    # Scalar properties only: one flat numeric stream for host.cpp's parser.
    if not any(d.startswith("LIST") for _, _, props in elements for _, d in props):
        total = sum(count * len(props) for _, count, props in elements)
        try:
            flat_all = parse_floats(raw, total)
        except ValueError as e:
            raise PlyError(f"Bad ASCII payload: {e}") from e
        out = {}
        pos = 0
        for name, count, props in elements:
            width = len(props)
            table = flat_all[pos : pos + count * width].reshape(count, width)
            pos += count * width
            out[name] = np.rec.fromarrays(
                [table[:, i].astype(d) for i, (_, d) in enumerate(props)],
                names=[n for n, _ in props],
            )
        return out

    text = raw.decode("ascii", errors="replace")
    tokens = text.split()
    pos = 0
    out = {}
    for name, count, props in elements:
        if any(d.startswith("LIST") for _, d in props):
            # Parse token-by-token (faces etc.); store nothing.
            for _ in range(count):
                for _, d in props:
                    if d.startswith("LIST"):
                        n = int(float(tokens[pos])); pos += 1 + n  # noqa: E702
                    else:
                        pos += 1
            continue
        width = len(props)
        flat = np.array(tokens[pos : pos + count * width], dtype=np.float64)
        if flat.size != count * width:
            raise PlyError(f"Truncated ASCII data for element {name}")
        pos += count * width
        table = flat.reshape(count, width)
        out[name] = np.rec.fromarrays(
            [table[:, i].astype(d) for i, (_, d) in enumerate(props)],
            names=[n for n, _ in props],
        )
    return out


def _read_binary_elements(f, elements, endian):
    out = {}
    for name, count, props in elements:
        if any(d.startswith("LIST") for _, d in props):
            # Variable-length rows (faces): skip by streaming.
            for _ in range(count):
                for _, d in props:
                    if d.startswith("LIST"):
                        _, ct, it = d.split(":")
                        n = int(np.frombuffer(f.read(np.dtype(ct).itemsize),
                                              dtype=endian + ct)[0])
                        f.seek(n * np.dtype(it).itemsize, 1)
                    else:
                        f.seek(np.dtype(d).itemsize, 1)
            continue
        dtype = np.dtype([(n, endian + d) for n, d in props])
        buf = f.read(dtype.itemsize * count)
        if len(buf) != dtype.itemsize * count:
            raise PlyError(f"Truncated binary data for element {name}")
        out[name] = np.frombuffer(buf, dtype=dtype)
    return out


def write_ply(
    path: str | Path,
    points: np.ndarray,
    *,
    normals: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    """Write a point cloud as PLY (binary little-endian by default).

    ``colors`` are float in [0,1] and stored as uchar.
    """
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    header = ["ply"]
    header.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    header.append("comment generated by tpu3dm")
    header.append(f"element vertex {n}")
    header += [f"property double {c}" for c in ("x", "y", "z")]
    fields = [("x", "<f8"), ("y", "<f8"), ("z", "<f8")]
    cols = [points[:, 0], points[:, 1], points[:, 2]]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float64)
        header += [f"property double n{c}" for c in ("x", "y", "z")]
        fields += [("nx", "<f8"), ("ny", "<f8"), ("nz", "<f8")]
        cols += [normals[:, 0], normals[:, 1], normals[:, 2]]
    if colors is not None:
        colors = np.clip(np.asarray(colors, dtype=np.float64), 0.0, 1.0)
        c8 = np.round(colors * 255.0).astype(np.uint8)
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        cols += [c8[:, 0], c8[:, 1], c8[:, 2]]
    header.append("end_header")

    path = Path(path)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            rec = np.zeros(n, dtype=fields)
            for (name, _), col in zip(fields, cols):
                rec[name] = col
            f.write(rec.tobytes())
        else:
            txt = _io.StringIO()
            for i in range(n):
                row = []
                for (name, d), col in zip(fields, cols):
                    v = col[i]
                    row.append(str(int(v)) if d == "u1" else repr(float(v)))
                txt.write(" ".join(row) + "\n")
            f.write(txt.getvalue().encode("ascii"))

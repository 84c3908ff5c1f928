"""Numpy PLY codec (binary little/big endian + ascii).

Own copy of the JAX package's `semantic_meshes/io/ply.py` (numpy only; the
port imports nothing of that package). Replaces the reference's
tinyply-based loader/saver
(ref: src/data/Ply.cpp:9-25, python/semantic_meshes/include/Ply.h:17-51).
Host-side binary IO is vectorized numpy; outputs feed torch pipelines.

Supported surface (superset of what the reference exercises):
- read: any element/property layout; list properties with arbitrary count
  types. Returns vertices (V, 3) float32 and faces (T, 3) int32 plus the raw
  element table for round-tripping.
- write: vertex x/y/z float32, face vertex_indices (uint8 count, int32
  values), optional per-face red/green/blue uint8 — the exact schema the
  reference emits (ref: python/semantic_meshes/include/Ply.h:31-34).
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass, field

import numpy as np

_PLY_TO_NP = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


@dataclass
class PlyProperty:
    name: str
    dtype: str  # numpy dtype string without byte order
    is_list: bool = False
    count_dtype: str = "u1"


@dataclass
class PlyElement:
    name: str
    count: int
    properties: list = field(default_factory=list)
    # parsed data: dict property name -> np.ndarray (lists -> object array or
    # (count, k) array when all rows have equal length)
    data: dict = field(default_factory=dict)


class PlyError(ValueError):
    pass


def _parse_header(f):
    magic = f.readline().strip()
    if magic != b"ply":
        raise PlyError("not a PLY file (missing 'ply' magic)")
    fmt = None
    elements = []
    while True:
        line = f.readline()
        if not line:
            raise PlyError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        # malformed lines (missing tokens, unknown type names, non-numeric
        # counts) must surface as PlyError, not IndexError/KeyError — found
        # by mutation fuzzing
        try:
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                count = int(tokens[2])
                if count < 0:
                    # a negative count would flow into np.frombuffer, where
                    # count=-1 means "read everything" — reject loudly
                    raise PlyError(
                        f"negative element count in PLY header: {count}"
                    )
                elements.append(PlyElement(tokens[1], count))
            elif tokens[0] == "property":
                if not elements:
                    raise PlyError("property before element in PLY header")
                if tokens[1] == "list":
                    elements[-1].properties.append(
                        PlyProperty(
                            tokens[4],
                            _PLY_TO_NP[tokens[3]],
                            is_list=True,
                            count_dtype=_PLY_TO_NP[tokens[2]],
                        )
                    )
                else:
                    elements[-1].properties.append(
                        PlyProperty(tokens[2], _PLY_TO_NP[tokens[1]])
                    )
            elif tokens[0] == "end_header":
                break
            else:
                raise PlyError(f"unknown PLY header line: {' '.join(tokens)}")
        except PlyError:
            raise
        except (IndexError, KeyError, ValueError):
            raise PlyError(
                f"malformed PLY header line: {' '.join(tokens)!r}"
            ) from None
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise PlyError(f"unsupported PLY format: {fmt}")
    return fmt, elements


def _read_binary_element(buf, offset, element, bo):
    """Parse one element from bytes. Returns new offset.

    Fast path: no list properties, or a single list property whose count is
    constant (probed from the first row) — both fully vectorized.
    """
    props = element.properties
    if element.count == 0:
        for p in props:
            element.data[p.name] = np.zeros((0,), dtype=p.dtype)
        return offset
    def from_buffer(dtype, count, off):
        try:
            return np.frombuffer(buf, dtype=dtype, count=count, offset=off)
        except ValueError:
            raise PlyError(
                f"truncated PLY body: element '{element.name}' declares "
                f"{element.count} rows but the file ends early"
            ) from None

    if not any(p.is_list for p in props):
        dt = np.dtype([(p.name, bo + p.dtype) for p in props])
        arr = from_buffer(dt, element.count, offset)
        for p in props:
            element.data[p.name] = arr[p.name]
        return offset + dt.itemsize * element.count

    # Probe first row's list count(s); assume fixed-size lists (true for mesh
    # faces; the reference's tinyply reader makes the same assumption by
    # typing faces as int32x3 with uint8 count, src/data/Ply.cpp:13).
    probe = offset
    counts = {}
    for p in props:
        if p.is_list:
            n = int(from_buffer(bo + p.count_dtype, 1, probe)[0])
            # negative (signed count dtype) or absurd counts would reach
            # np.dtype below as a bad subarray shape (raw ValueError);
            # any real count fits the buffer at least once
            if n < 0 or n * np.dtype(p.dtype).itemsize > len(buf):
                raise PlyError(
                    f"implausible list count {n} for property '{p.name}' "
                    f"in element '{element.name}'"
                )
            counts[p.name] = n
            probe += np.dtype(p.count_dtype).itemsize + n * np.dtype(p.dtype).itemsize
        else:
            probe += np.dtype(p.dtype).itemsize
    fields = []
    for p in props:
        if p.is_list:
            fields.append((p.name + "__n", bo + p.count_dtype))
            fields.append((p.name, bo + p.dtype, (counts[p.name],)))
        else:
            fields.append((p.name, bo + p.dtype))
    dt = np.dtype(fields)
    arr = from_buffer(dt, element.count, offset)
    for p in props:
        if p.is_list:
            if not np.all(arr[p.name + "__n"] == counts[p.name]):
                raise PlyError(
                    f"variable-length list property '{p.name}' in element "
                    f"'{element.name}' is not supported by the fast reader"
                )
            element.data[p.name] = arr[p.name]
        else:
            element.data[p.name] = arr[p.name]
    return offset + dt.itemsize * element.count


def _read_ascii_elements(f, elements):
    # One token stream for the whole body; vectorized with np.loadtxt-like
    # splitting. Lists require row-wise parsing; keep it simple and correct.
    body = f.read().decode("ascii", "replace")
    rows = [r.split() for r in body.splitlines() if r.strip()]
    cursor = 0
    for element in elements:
        has_list = any(p.is_list for p in element.properties)
        chunk = rows[cursor : cursor + element.count]
        cursor += element.count
        if len(chunk) < element.count:
            raise PlyError(
                f"truncated PLY body: element '{element.name}' declares "
                f"{element.count} rows, found {len(chunk)}"
            )
        # malformed rows (short, non-numeric, bad list counts) must surface
        # as PlyError, not IndexError — found by mutation fuzzing
        try:
            if element.count == 0:
                for p in element.properties:
                    element.data[p.name] = np.zeros((0,), dtype=p.dtype)
            elif not has_list:
                mat = np.asarray(chunk, dtype=np.float64)
                if mat.ndim != 2 or mat.shape[1] < len(element.properties):
                    raise PlyError(
                        f"malformed rows in PLY element '{element.name}'"
                    )
                for j, p in enumerate(element.properties):
                    element.data[p.name] = mat[:, j].astype(p.dtype)
            else:
                cols = {p.name: [] for p in element.properties}
                for row in chunk:
                    i = 0
                    for p in element.properties:
                        if p.is_list:
                            n = int(row[i])
                            if n < 0 or i + 1 + n > len(row):
                                raise PlyError(
                                    f"malformed list row in PLY element "
                                    f"'{element.name}'"
                                )
                            cols[p.name].append(row[i + 1 : i + 1 + n])
                            i += 1 + n
                        else:
                            if i >= len(row):
                                raise PlyError(
                                    f"short row in PLY element "
                                    f"'{element.name}'"
                                )
                            cols[p.name].append(row[i])
                            i += 1
                for p in element.properties:
                    element.data[p.name] = np.asarray(
                        cols[p.name], dtype=p.dtype
                    )
        except PlyError:
            raise
        except (IndexError, ValueError):
            raise PlyError(
                f"malformed rows in PLY element '{element.name}'"
            ) from None
    return elements


def read_ply(path):
    """Read a PLY file. Returns dict element name -> PlyElement."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        if fmt == "ascii":
            _read_ascii_elements(f, elements)
        else:
            bo = "<" if fmt == "binary_little_endian" else ">"
            buf = f.read()
            offset = 0
            for element in elements:
                offset = _read_binary_element(buf, offset, element, bo)
    return {e.name: e for e in elements}


def read_mesh(path):
    """Read (vertices (V,3) f32, faces (T,3) i32) from a PLY mesh.

    Same contract as the reference loader: vertex x/y/z, face vertex_indices
    (ref: src/data/Ply.cpp:10-14). Raises PlyError on missing elements.
    """
    elements = read_ply(path)
    if "vertex" not in elements:
        raise PlyError(f"{path}: PLY file has no 'vertex' element")
    if "face" not in elements:
        raise PlyError(f"{path}: PLY file has no 'face' element")
    v = elements["vertex"]
    try:
        vertices = np.stack(
            [v.data["x"], v.data["y"], v.data["z"]], axis=-1
        ).astype(np.float32)
    except KeyError as e:
        raise PlyError(f"{path}: vertex element missing property {e}") from None
    fdata = elements["face"].data
    key = "vertex_indices" if "vertex_indices" in fdata else "vertex_index"
    if key not in fdata:
        raise PlyError(f"{path}: face element has no vertex_indices property")
    faces = np.asarray(fdata[key], dtype=np.int32)
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise PlyError(
            f"{path}: only triangle meshes are supported, got faces {faces.shape}"
        )
    return vertices, faces


def write_mesh(path, vertices, faces, face_colors=None, binary=True):
    """Write a triangle mesh, optionally with per-face RGB uint8 colors.

    Property schema matches the reference save path exactly: vertex x/y/z
    float, face vertex_indices (uchar count, int32) + per-face uchar
    red/green/blue (ref: python/semantic_meshes/include/Ply.h:31-34).
    """
    vertices = np.ascontiguousarray(vertices, dtype=np.float32)
    faces = np.ascontiguousarray(faces, dtype=np.int32)
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise PlyError(f"vertices must be (V, 3), got {vertices.shape}")
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise PlyError(f"faces must be (T, 3), got {faces.shape}")
    if face_colors is not None:
        face_colors = np.ascontiguousarray(face_colors, dtype=np.uint8)
        if face_colors.shape != (faces.shape[0], 3):
            raise PlyError(
                f"face_colors must be ({faces.shape[0]}, 3), got {face_colors.shape}"
            )

    header = _io.BytesIO()
    header.write(b"ply\n")
    header.write(
        b"format binary_little_endian 1.0\n" if binary else b"format ascii 1.0\n"
    )
    header.write(b"comment written by semantic-meshes (TPU)\n")
    header.write(f"element vertex {len(vertices)}\n".encode())
    header.write(b"property float x\nproperty float y\nproperty float z\n")
    header.write(f"element face {len(faces)}\n".encode())
    header.write(b"property list uchar int vertex_indices\n")
    if face_colors is not None:
        header.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\n")
    header.write(b"end_header\n")

    with open(path, "wb") as f:
        f.write(header.getvalue())
        if binary:
            f.write(vertices.astype("<f4").tobytes())
            fields = [("n", "u1"), ("idx", "<i4", (3,))]
            if face_colors is not None:
                fields += [("r", "u1"), ("g", "u1"), ("b", "u1")]
            rec = np.empty(len(faces), dtype=np.dtype(fields))
            rec["n"] = 3
            rec["idx"] = faces
            if face_colors is not None:
                rec["r"], rec["g"], rec["b"] = (
                    face_colors[:, 0],
                    face_colors[:, 1],
                    face_colors[:, 2],
                )
            f.write(rec.tobytes())
        else:
            lines = ["%.9g %.9g %.9g" % tuple(v) for v in vertices]
            for i, face in enumerate(faces):
                row = "3 %d %d %d" % tuple(face)
                if face_colors is not None:
                    row += " %d %d %d" % tuple(face_colors[i])
                lines.append(row)
            f.write(("\n".join(lines) + "\n").encode())

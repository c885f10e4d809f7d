"""Minimal PLY point-cloud I/O, ASCII and binary little-endian
(counterpart of ``pointcloudlib_tpu/utils/ply.py``, the same code): the
format of KPConv's kernel-point disposition cache. float32, float64,
int32 and uint8 scalar properties.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

_DTYPES = {
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
    "int": np.int32, "int32": np.int32,
    "uchar": np.uint8, "uint8": np.uint8,
}
_NAMES = {np.dtype(np.float32): "float", np.dtype(np.float64): "double",
          np.dtype(np.int32): "int", np.dtype(np.uint8): "uchar"}


def write_ply(
    path: str | Path,
    fields: Dict[str, np.ndarray],
    binary: bool = True,
) -> None:
    """``fields``: name → [N] or [N, k] arrays; multi-column fields are
    expanded as name_0, name_1, … except 'xyz'/'points' → x,y,z and
    'normals' → nx,ny,nz."""
    cols: List[Tuple[str, np.ndarray]] = []
    special = {"xyz": "xyz", "points": "xyz", "normals": ("nx", "ny", "nz"),
               "rgb": ("red", "green", "blue")}
    n = None
    for name, arr in fields.items():
        arr = np.asarray(arr)
        n = len(arr) if n is None else n
        assert len(arr) == n, f"field {name} length mismatch"
        if arr.ndim == 1:
            cols.append((name, arr))
        else:
            if name in special:
                sub = special[name]
                names = list(sub) if isinstance(sub, tuple) else list("xyz")
            else:
                names = [f"{name}_{i}" for i in range(arr.shape[1])]
            for i, cn in enumerate(names):
                cols.append((cn, arr[:, i]))

    fmt = "binary_little_endian" if binary else "ascii"
    header = [
        "ply", f"format {fmt} 1.0", f"element vertex {n}",
    ]
    for cn, arr in cols:
        if arr.dtype not in _NAMES:
            raise TypeError(
                f"field {cn!r}: unsupported dtype {arr.dtype} — cast "
                f"to one of {sorted(str(d) for d in _NAMES)} first "
                "(e.g. labels .astype(np.int32))")
        header.append(f"property {_NAMES[arr.dtype]} {cn}")
    header.append("end_header")

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        rec = np.rec.fromarrays(
            [arr for _, arr in cols], names=[cn for cn, _ in cols]
        )
        if binary:
            f.write(rec.tobytes())
        else:
            for row in rec:
                f.write(
                    (" ".join(str(v) for v in row) + "\n").encode()
                )


def read_ply(path: str | Path) -> Dict[str, np.ndarray]:
    """Returns name → [N] column arrays (x/y/z etc. kept separate)."""
    with open(path, "rb") as f:
        line = f.readline().decode().strip()
        assert line == "ply", f"not a PLY file: {path}"
        fmt = None
        n = 0
        props: List[Tuple[str, np.dtype]] = []
        while True:
            line = f.readline().decode().strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                _, typ, name = line.split()
                props.append((name, np.dtype(_DTYPES[typ])))
            elif line == "end_header":
                break
        if fmt == "ascii":
            raw = np.loadtxt(f, max_rows=n, ndmin=2)
            return {
                name: raw[:, i].astype(dt)
                for i, (name, dt) in enumerate(props)
            }
        dtype = np.dtype([(name, dt) for name, dt in props])
        rec = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype)
        return {name: np.array(rec[name]) for name, _ in props}

"""Self-contained NetCDF-3 (classic / 64-bit-offset) reader and writer.

The reference's dataset format is NetCDF classic (`README:600-645`): dims
numSeqs/numTimesteps/inputPattSize/{numLabels|targetPattSize}/maxSeqTagLength,
vars seqTags/seqLengths/inputs/{targetClasses|targetPatterns} plus optional
inputMeans/inputStdevs/outputMeans/outputStdevs. The reference links the
system libnetcdf; we implement the on-disk format directly (it is a simple
big-endian container) so the framework and its tools (htk2nc, nc-standardize)
have zero native dependencies for IO and can also WRITE datasets.

Format: CDF-1 ('CDF\\x01', 32-bit offsets) and CDF-2 ('CDF\\x02', 64-bit
offsets). CURRENNT-produced files have fixed-size variables only, but a
record (UNLIMITED) dimension — legal CDF and producible by third-party HTK
pipelines — is also read correctly: record variables are de-interleaved per
record slab. Reading memory-maps nothing — variables are lazily sliceable
via `NetCDF3File.read(name, start, count)` for streaming large corpora.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NC_BYTE, NC_CHAR, NC_SHORT, NC_INT, NC_FLOAT, NC_DOUBLE = 1, 2, 3, 4, 5, 6
NC_DIMENSION, NC_VARIABLE, NC_ATTRIBUTE = 0x0A, 0x0B, 0x0C

_DTYPES = {
    NC_BYTE: np.dtype(">i1"),
    NC_CHAR: np.dtype("S1"),
    NC_SHORT: np.dtype(">i2"),
    NC_INT: np.dtype(">i4"),
    NC_FLOAT: np.dtype(">f4"),
    NC_DOUBLE: np.dtype(">f8"),
}
_NCTYPE_OF = {
    np.dtype("int8"): NC_BYTE,
    np.dtype("S1"): NC_CHAR,
    np.dtype("int16"): NC_SHORT,
    np.dtype("int32"): NC_INT,
    np.dtype("float32"): NC_FLOAT,
    np.dtype("float64"): NC_DOUBLE,
}


def _pad4(n: int) -> int:
    return (n + 3) & ~3


class Var:
    def __init__(self, name, dims, nc_type, begin, shape, dim_names=(),
                 is_record=False):
        self.name = name
        self.dims = dims
        self.nc_type = nc_type
        self.begin = begin
        self.shape = shape
        self.dim_names = tuple(dim_names)
        self.is_record = is_record

    @property
    def dtype(self):
        return _DTYPES[self.nc_type]

    @property
    def size(self):
        n = 1
        for s in self.shape:
            n *= s
        return n


class NetCDF3File:
    """Read-only handle with lazy slicing along the first dimension."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        magic = self._f.read(4)
        if magic[:3] != b"CDF" or magic[3] not in (1, 2):
            raise ValueError(f"{path}: not a NetCDF classic file")
        self._offsize = 8 if magic[3] == 2 else 4
        self._numrecs = self._u4()
        self.dimensions: Dict[str, int] = {}
        self._dim_sizes: List[int] = []
        self._read_dim_list()
        self.attributes = self._read_att_list()
        self.variables: Dict[str, Var] = {}
        self._recsize = 0
        self._read_var_list()
        self._finalize_records()

    # ------------------------------------------------------------- primitives
    def _u4(self) -> int:
        return struct.unpack(">I", self._f.read(4))[0]

    def _name(self) -> str:
        n = self._u4()
        s = self._f.read(_pad4(n))[:n]
        return s.decode("utf-8")

    def _read_dim_list(self):
        tag = self._u4()
        count = self._u4()
        if tag == 0 and count == 0:
            return
        if tag != NC_DIMENSION:
            raise ValueError("bad dim_list tag")
        for _ in range(count):
            name = self._name()
            size = self._u4()
            self.dimensions[name] = size
            self._dim_sizes.append(size)

    def _read_att_list(self) -> Dict[str, object]:
        tag = self._u4()
        count = self._u4()
        atts: Dict[str, object] = {}
        if tag == 0 and count == 0:
            return atts
        if tag != NC_ATTRIBUTE:
            raise ValueError("bad att_list tag")
        for _ in range(count):
            name = self._name()
            nc_type = self._u4()
            n = self._u4()
            nbytes = n * _DTYPES[nc_type].itemsize
            raw = self._f.read(_pad4(nbytes))[:nbytes]
            if nc_type == NC_CHAR:
                atts[name] = raw.decode("utf-8", "replace")
            else:
                atts[name] = np.frombuffer(raw, dtype=_DTYPES[nc_type])
        return atts

    def _read_var_list(self):
        tag = self._u4()
        count = self._u4()
        if tag == 0 and count == 0:
            return
        if tag != NC_VARIABLE:
            raise ValueError("bad var_list tag")
        for _ in range(count):
            name = self._name()
            ndims = self._u4()
            dimids = [self._u4() for _ in range(ndims)]
            self._read_att_list()  # per-var attributes (unused)
            nc_type = self._u4()
            self._u4()  # vsize (may be wrong for >2GB; recomputed from shape)
            if self._offsize == 8:
                begin = struct.unpack(">Q", self._f.read(8))[0]
            else:
                begin = self._u4()
            shape = tuple(self._dim_sizes[d] for d in dimids)
            dim_names = tuple(list(self.dimensions)[d] for d in dimids)
            # a dim of size 0 in the header is the record (UNLIMITED) dim;
            # only the first dim of a variable may be it
            is_record = bool(dimids) and self._dim_sizes[dimids[0]] == 0
            self.variables[name] = Var(name, dimids, nc_type, begin, shape,
                                       dim_names, is_record)

    def _finalize_records(self):
        """Resolve record-variable shapes and the interleaved record size."""
        rec_vars = [v for v in self.variables.values() if v.is_record]
        if not rec_vars:
            return
        slabs = []
        for v in rec_vars:
            inner = 1
            for s in v.shape[1:]:
                inner *= s
            slabs.append(inner * v.dtype.itemsize)
        # each record holds one slab per record variable, 4-byte padded —
        # except a single record variable, which is packed without padding
        if len(rec_vars) == 1:
            self._recsize = slabs[0]
        else:
            self._recsize = sum(_pad4(s) for s in slabs)
        numrecs = self._numrecs
        if numrecs == 0xFFFFFFFF:  # STREAMING: infer from the file length
            import os
            end = os.fstat(self._f.fileno()).st_size
            first = min(v.begin for v in rec_vars)
            numrecs = max(0, (end - first) // self._recsize) if self._recsize else 0
        for v in rec_vars:
            v.shape = (numrecs,) + v.shape[1:]
            for n, d in zip(v.dim_names, v.dims):
                if self._dim_sizes[d] == 0:
                    self.dimensions[n] = numrecs

    # ------------------------------------------------------------------- read
    def read(self, name: str, start: int = 0, count: Optional[int] = None) -> np.ndarray:
        """Read `count` slices of variable `name` along its first dimension."""
        v = self.variables[name]
        if not v.shape:
            self._f.seek(v.begin)
            return np.frombuffer(self._f.read(v.dtype.itemsize), dtype=v.dtype)[0]
        first = v.shape[0]
        if count is None:
            count = first - start
        inner = 1
        for s in v.shape[1:]:
            inner *= s
        item = v.dtype.itemsize
        if v.is_record and self._recsize != inner * item:
            # records interleave one slab per record variable: one bulk read
            # of the span, then a strided gather of our slabs (a seek+read
            # per record would multiply corpus-streaming I/O by orders of
            # magnitude)
            slab = inner * item
            need = (count - 1) * self._recsize + slab if count else 0
            self._f.seek(v.begin + start * self._recsize)
            span = self._f.read(need)
            if len(span) < need:  # as_strided does NOT bounds-check
                raise ValueError(
                    f"{self.path}: truncated record data for '{name}' "
                    f"(needed {need} bytes, got {len(span)})")
            a = np.frombuffer(span, np.uint8)
            rows = np.lib.stride_tricks.as_strided(
                a, (count, slab), (self._recsize, 1)).copy()
            buf = rows.tobytes()
        else:
            # fixed-size variable, or the single record variable (whose
            # records are packed contiguously: recsize == slab)
            self._f.seek(v.begin + start * inner * item)
            buf = self._f.read(count * inner * item)
        arr = np.frombuffer(buf, dtype=v.dtype).reshape((count,) + v.shape[1:])
        if v.nc_type == NC_CHAR:
            return arr
        return arr.astype(arr.dtype.newbyteorder("="))

    def read_strings(self, name: str) -> List[str]:
        """Read a [N, maxLen] char variable as a list of NUL-stripped strings."""
        arr = self.read(name)
        out = []
        for row in arr:
            b = row.tobytes()
            nul = b.find(b"\0")
            out.append((b[:nul] if nul >= 0 else b).decode("utf-8", "replace"))
        return out

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_netcdf(path: str) -> Tuple[Dict[str, int], Dict[str, np.ndarray]]:
    """Eagerly read all dimensions and variables."""
    with NetCDF3File(path) as f:
        return dict(f.dimensions), {k: f.read(k) for k in f.variables}


def write_netcdf(path: str, dims: Dict[str, int],
                 variables: Sequence[Tuple[str, Sequence[str], np.ndarray]],
                 version: int = 1) -> None:
    """Write a classic NetCDF file with fixed-size variables.

    variables: list of (name, dim_names, array). Array dtypes map to nc types;
    strings must be pre-encoded as S1 char arrays.
    """
    dim_names = list(dims)
    dim_ids = {n: i for i, n in enumerate(dim_names)}

    def name_bytes(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack(">I", len(b)) + b + b"\0" * (_pad4(len(b)) - len(b))

    header = bytearray()
    header += b"CDF" + bytes([version])
    header += struct.pack(">I", 0)  # numrecs
    header += struct.pack(">II", NC_DIMENSION, len(dim_names))
    for n in dim_names:
        header += name_bytes(n) + struct.pack(">I", dims[n])
    header += struct.pack(">II", 0, 0)  # no global atts

    # prepare variable records; data offsets filled after header size known
    var_recs = []
    arrays = []
    for name, vdims, arr in variables:
        arr = np.asarray(arr)
        base = arr.dtype
        if base == np.dtype("int64"):
            arr = arr.astype(np.int32)
            base = arr.dtype
        if base.kind == "S" and base.itemsize != 1:
            raise ValueError("encode strings to S1 char arrays first")
        nc_type = _NCTYPE_OF[np.dtype(base.newbyteorder("="))]
        shape = tuple(dims[d] for d in vdims)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape} != dims {shape}")
        be = arr.astype(_DTYPES[nc_type])
        vsize = _pad4(be.nbytes)
        var_recs.append((name, vdims, nc_type, vsize))
        arrays.append(be)

    offsize = 8 if version == 2 else 4
    # compute header length
    vhdr = bytearray()
    vhdr += struct.pack(">II", NC_VARIABLE, len(var_recs))
    fixed_parts = []
    for name, vdims, nc_type, vsize in var_recs:
        p = bytearray()
        p += name_bytes(name)
        p += struct.pack(">I", len(vdims))
        for d in vdims:
            p += struct.pack(">I", dim_ids[d])
        p += struct.pack(">II", 0, 0)  # no var atts
        p += struct.pack(">II", nc_type, min(vsize, 0xFFFFFFFF))
        fixed_parts.append(bytes(p))
    header_len = len(header) + len(vhdr) + sum(len(p) + offsize for p in fixed_parts)

    begin = header_len
    begins = []
    for (_, _, _, vsize) in var_recs:
        begins.append(begin)
        begin += vsize

    with open(path, "wb") as f:
        f.write(header)
        f.write(vhdr)
        for p, b in zip(fixed_parts, begins):
            f.write(p)
            if offsize == 8:
                f.write(struct.pack(">Q", b))
            else:
                f.write(struct.pack(">I", b))
        for (name, vdims, nc_type, vsize), be in zip(var_recs, arrays):
            f.write(be.tobytes())
            f.write(b"\0" * (vsize - be.nbytes))


def strings_to_chars(strings: Sequence[str], max_len: int) -> np.ndarray:
    out = np.zeros((len(strings), max_len), dtype="S1")
    for i, s in enumerate(strings):
        b = s.encode("utf-8")[:max_len]
        out[i, : len(b)] = np.frombuffer(b, dtype="S1")
    return out

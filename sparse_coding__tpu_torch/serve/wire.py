"""Serving wire formats: JSON, npz and a raw little-endian binary.

Counterpart of the JAX package's `serve/wire.py`: the same three formats,
the same content types, dtype codes, ``SCW1`` raw header and the json
``__dtypes__`` / npz ``__meta__`` layouts, so a payload either package
writes is byte for byte the one the other writes for the same arrays, and
each decodes the other's.

  - **json** (``application/json``): arrays as nested lists (every carried
    dtype embeds in f64, so json is bit-exact), their dtypes by name under
    ``__dtypes__``;
  - **npz** (``application/x-npz``): `numpy.savez`, metadata as a
    ``__meta__`` uint8 array of UTF-8 JSON;
  - **raw** (``application/x-sc-raw``): the repo's header + payload layout::

        magic   4s   b"SCW1"
        version u16  1
        n_arr   u16  number of arrays
        mlen    u32  meta JSON byte length
        meta    mlen bytes of UTF-8 JSON
        then per array:
          nlen  u16  name byte length
          name  nlen bytes of UTF-8
          dtype u8   code from DTYPE_CODES
          ndim  u8
          shape u64 * ndim
          data  prod(shape) * itemsize bytes (C order)

bf16: numpy has no bfloat16 of its own, and the port does not use the
package that adds one. A bf16 array is a CPU ``torch.bfloat16`` tensor at
this boundary: it travels as its uint16 bit pattern (as npz always carried
it) under the dtype name ``"bfloat16"``, and decodes back to a
``torch.bfloat16`` tensor. Every other dtype is a numpy array both ways
(torch tensors of those dtypes are accepted and sent as numpy).
"""

from __future__ import annotations

import io
import json
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "FORMATS",
    "CONTENT_TYPES",
    "DTYPE_CODES",
    "format_of_content_type",
    "negotiate",
    "encode_payload",
    "decode_payload",
    "dtype_by_name",
    "dtype_name",
    "as_host_array",
]

FORMATS = ("json", "npz", "raw")

CONTENT_TYPES = {
    "json": "application/json",
    "npz": "application/x-npz",
    "raw": "application/x-sc-raw",
}
_FORMAT_OF = {v: k for k, v in CONTENT_TYPES.items()}
# permissive aliases clients in the wild send
_FORMAT_OF["application/octet-stream"] = "raw"
_FORMAT_OF["application/zip"] = "npz"

_MAGIC = b"SCW1"
_VERSION = 1

# stable u8 dtype codes for the raw format (never renumber: wire contract)
DTYPE_CODES = {
    "float32": 0,
    "float16": 1,
    "bfloat16": 2,
    "float64": 3,
    "int8": 4,
    "int16": 5,
    "int32": 6,
    "int64": 7,
    "uint8": 8,
    "uint32": 9,
    "bool": 10,
}
_DTYPE_OF_CODE = {v: k for k, v in DTYPE_CODES.items()}


def dtype_by_name(name: str):
    """The host dtype for a wire dtype name: ``torch.bfloat16`` for
    ``"bfloat16"``, else the numpy dtype."""
    if name == "bfloat16":
        return torch.bfloat16
    return np.dtype(name)


def as_host_array(v):
    """A payload array in its host form: a CPU ``torch.bfloat16`` tensor for
    bf16, a numpy array for everything else."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.contiguous() if v.dtype == torch.bfloat16 else v.numpy()
    return np.asarray(v)


def dtype_name(arr) -> str:
    """The wire name of a host array's dtype."""
    if isinstance(arr, torch.Tensor):
        return str(arr.dtype).rpartition(".")[2]
    return arr.dtype.name


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _bf16_of_bits(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def format_of_content_type(content_type: Optional[str]) -> str:
    """Wire format named by a Content-Type header (parameters stripped);
    absent/unknown: ``"json"`` (the compatible default)."""
    if not content_type:
        return "json"
    base = content_type.split(";", 1)[0].strip().lower()
    return _FORMAT_OF.get(base, "json")


def negotiate(accept: Optional[str]) -> str:
    """Response format for an ``Accept`` header: the first recognized serve
    content type wins (q-values ignored); ``*/*`` or absent: json."""
    if not accept:
        return "json"
    for part in accept.split(","):
        base = part.split(";", 1)[0].strip().lower()
        if base in _FORMAT_OF:
            return _FORMAT_OF[base]
    return "json"


# -- codecs --------------------------------------------------------------------

def _json_array(arr):
    """Nested lists, exactly representable: every carried dtype embeds in f64."""
    if isinstance(arr, torch.Tensor):
        return arr.to(torch.float64).numpy().tolist()
    if arr.dtype.kind in ("i", "u", "b"):
        return arr.tolist()
    return np.asarray(arr, dtype=np.float64).tolist()


def _encode_json(arrays: Dict[str, Any], meta: Dict[str, Any]) -> bytes:
    body = dict(meta)
    body["__dtypes__"] = {k: dtype_name(v) for k, v in arrays.items()}
    for k, v in arrays.items():
        body[k] = _json_array(v)
    return json.dumps(body).encode()


def _decode_json(buf: bytes) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    body = json.loads(buf)
    if not isinstance(body, dict):
        raise ValueError("json payload must be an object")
    dtypes = body.pop("__dtypes__", {})
    arrays: Dict[str, Any] = {}
    meta: Dict[str, Any] = {}
    for k, v in body.items():
        if k in dtypes:
            if dtypes[k] == "bfloat16":
                arrays[k] = torch.tensor(np.asarray(v, dtype=np.float64)).to(torch.bfloat16)
            else:
                arrays[k] = np.asarray(v, dtype=dtype_by_name(dtypes[k]))
        else:
            meta[k] = v
    return arrays, meta


def _encode_npz(arrays: Dict[str, Any], meta: Dict[str, Any]) -> bytes:
    out = io.BytesIO()
    to_save = {}
    for k, v in arrays.items():
        # np.save cannot write bf16: its u16 bit pattern, restored by name
        to_save[k] = _bf16_bits(v) if isinstance(v, torch.Tensor) else v
    to_save["__meta__"] = np.frombuffer(
        json.dumps({"meta": meta, "dtypes": {k: dtype_name(v) for k, v in arrays.items()}}).encode(),
        dtype=np.uint8,
    )
    np.savez(out, **to_save)
    return out.getvalue()


def _decode_npz(buf: bytes) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    with np.load(io.BytesIO(buf)) as z:
        files = {k: z[k] for k in z.files}
    blob = files.pop("__meta__", None)
    info = json.loads(bytes(blob.tobytes()).decode()) if blob is not None else {"meta": {}, "dtypes": {}}
    arrays: Dict[str, Any] = {}
    for k, v in files.items():
        want = info["dtypes"].get(k)
        if want == "bfloat16":
            arrays[k] = _bf16_of_bits(v)
        elif want and want != v.dtype.name:
            arrays[k] = v.view(dtype_by_name(want))
        else:
            arrays[k] = v
    return arrays, info.get("meta", {})


def _encode_raw(arrays: Dict[str, Any], meta: Dict[str, Any]) -> bytes:
    mbytes = json.dumps(meta).encode()
    parts = [_MAGIC, struct.pack("<HHI", _VERSION, len(arrays), len(mbytes)), mbytes]
    for name, arr in arrays.items():
        dname = dtype_name(arr)
        if dname not in DTYPE_CODES:
            raise ValueError(f"raw format cannot carry dtype {dname!r}")
        nbytes = name.encode()
        if isinstance(arr, torch.Tensor):
            shape, data = tuple(arr.shape), _bf16_bits(arr)
        else:
            arr = np.ascontiguousarray(arr)
            # little-endian on the wire whatever the host: astype swaps the
            # bytes of big-endian input (a view would only relabel them)
            shape, data = arr.shape, (arr.astype(arr.dtype.newbyteorder("<")) if arr.dtype.byteorder == ">" else arr)
        parts.append(struct.pack("<H", len(nbytes)))
        parts.append(nbytes)
        parts.append(struct.pack("<BB", DTYPE_CODES[dname], len(shape)))
        parts.append(struct.pack(f"<{len(shape)}Q", *shape))
        parts.append(data.tobytes())
    return b"".join(parts)


def _decode_raw(buf: bytes) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    if buf[:4] != _MAGIC:
        raise ValueError("not a SCW1 raw payload (bad magic)")
    version, n_arr, mlen = struct.unpack_from("<HHI", buf, 4)
    if version != _VERSION:
        raise ValueError(f"unsupported raw wire version {version}")
    off = 12
    meta = json.loads(buf[off: off + mlen]) if mlen else {}
    off += mlen
    arrays: Dict[str, Any] = {}
    for _ in range(n_arr):
        (nlen,) = struct.unpack_from("<H", buf, off)
        off += 2
        name = buf[off: off + nlen].decode()
        off += nlen
        code, ndim = struct.unpack_from("<BB", buf, off)
        off += 2
        shape = struct.unpack_from(f"<{ndim}Q", buf, off)
        off += 8 * ndim
        dname = _DTYPE_OF_CODE[code]
        dt = np.dtype(np.uint16) if dname == "bfloat16" else np.dtype(dname)
        count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
        nbytes = count * dt.itemsize
        if off + nbytes > len(buf):
            raise ValueError("raw payload truncated")
        # copy: own the memory, callers may outlive the buffer
        a = np.frombuffer(buf, dtype=dt, count=count, offset=off).reshape(shape).copy()
        arrays[name] = _bf16_of_bits(a) if dname == "bfloat16" else a
        off += nbytes
    return arrays, meta


_ENCODERS = {"json": _encode_json, "npz": _encode_npz, "raw": _encode_raw}
_DECODERS = {"json": _decode_json, "npz": _decode_npz, "raw": _decode_raw}


def encode_payload(fmt: str, arrays: Dict[str, Any], meta: Dict[str, Any]) -> bytes:
    """Serialize ``(arrays, meta)`` in wire format ``fmt``. Array dtypes
    travel exactly; meta must be plain JSON-able scalars/lists."""
    if fmt not in _ENCODERS:
        raise ValueError(f"unknown wire format {fmt!r} (want one of {FORMATS})")
    return _ENCODERS[fmt]({k: as_host_array(v) for k, v in arrays.items()}, meta)


def decode_payload(fmt: str, buf: bytes) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Inverse of `encode_payload`, bit-exact for every carried dtype. Any
    malformed payload raises ``ValueError`` (the server answers 400)."""
    if fmt not in _DECODERS:
        raise ValueError(f"unknown wire format {fmt!r} (want one of {FORMATS})")
    try:
        return _DECODERS[fmt](bytes(buf))
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"malformed {fmt} payload: {type(e).__name__}: {e}") from e

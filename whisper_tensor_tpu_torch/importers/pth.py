""".pth (PyTorch checkpoint) reader.

Counterpart of whisper_tensor_tpu/importers/pth.py, which parses the
zip container and the pickle by hand because the JAX package has no
torch; the port has torch, so `torch.load` reads the file, restricted
to tensors and plain containers (`weights_only`) and memory-mapped, so
a tensor's bytes are read when it is taken.

`load_pth_lazy` (the reference's :285-373) also needs where each
tensor's bytes lie in the file, which `torch.load` does not tell: it
reads data.pkl with a restricted unpickler that records each tensor's
storage key, offset, shape and strides (and builds nothing), and takes
each storage's offset from its zip member, as the reference does. A
dense tensor then loads its own span (an ExternalBinary); only one that
is not dense row-major goes through `torch.load`.
"""

from __future__ import annotations

import os
import pickle
import struct
import zipfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..dtype import DType, to_host

_STORAGE_DTYPES = {
    "FloatStorage": DType.F32,
    "DoubleStorage": DType.F64,
    "HalfStorage": DType.F16,
    "BFloat16Storage": DType.BF16,
    "LongStorage": DType.I64,
    "IntStorage": DType.I32,
    "ShortStorage": DType.I16,
    "CharStorage": DType.I8,
    "ByteStorage": DType.U8,
    "BoolStorage": DType.BOOL,
}


def load_pth(path: str) -> Dict[str, np.ndarray]:
    """A torch.save'd state dict -> {name: host array}, each tensor in
    its own type (bf16 widened to f32, which holds it exactly: numpy has
    no bf16). A top-level 'state_dict' entry is taken as the state dict,
    as the reference's reader takes it; entries that are not tensors are
    left out."""
    obj = torch.load(path, map_location="cpu", weights_only=True,
                     mmap=True)
    if isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    out: Dict[str, np.ndarray] = {}
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            t = v.detach()
            out[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


class _Storage:
    def __init__(self, dtype: DType, key: str):
        self.dtype, self.key = dtype, key


class _TensorRef:
    """Where a tensor of data.pkl lies: its storage, the element offset
    into it, its shape and strides."""

    def __init__(self, storage: _Storage, offset: int, shape, strides):
        self.storage, self.offset = storage, int(offset)
        self.shape = tuple(int(d) for d in shape)
        self.strides = tuple(int(s) for s in strides)


def _rebuild_tensor(storage, offset, shape, strides, *_):
    return _TensorRef(storage, offset, shape, strides)


def _rebuild_parameter(data, *_):
    return data


class _RefUnpickler(pickle.Unpickler):
    """data.pkl's objects with each tensor as a _TensorRef. Only the
    callables torch.save writes for tensors, parameters and ordered
    dicts are allowed; anything else raises."""

    _ALLOWED = {("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor,
                ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
                ("collections", "OrderedDict"): dict}

    def __init__(self, data: bytes, storages: Dict[str, _Storage]):
        import io

        super().__init__(io.BytesIO(data))
        self.storages = storages

    def find_class(self, module, name):
        if module == "torch" and name in _STORAGE_DTYPES:
            return name
        fn = self._ALLOWED.get((module, name))
        if fn is None:
            raise pickle.UnpicklingError(
                f"pth: {module}.{name} is not a tensor or container")
        return fn

    def persistent_load(self, pid):
        if pid[0] != "storage":
            raise pickle.UnpicklingError(f"pth: persistent id {pid!r}")
        st_name, key = pid[1], str(pid[2])
        if key not in self.storages:
            self.storages[key] = _Storage(
                _STORAGE_DTYPES.get(st_name, DType.U8), key)
        return self.storages[key]


def _zip_data_offset(zf: zipfile.ZipFile, member: str) -> int:
    """Absolute byte offset of a zip member's payload. Torch writes
    checkpoint storages ZIP_STORED (uncompressed), so the payload is a
    contiguous raw byte span — exactly what an OriginReference ONNX
    points at. The local file header's own name/extra lengths are read
    (they can differ from the central directory's)."""
    info = zf.getinfo(member)
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"pth member {member!r} is compressed; "
                         "OriginReference needs raw byte spans")
    fp = zf.fp
    fp.seek(info.header_offset + 26)
    fnlen, extralen = struct.unpack("<HH", fp.read(4))
    return info.header_offset + 30 + fnlen + extralen


def _take(path: str, keys: Tuple[Any, ...]) -> np.ndarray:
    """The tensor at `keys` of the checkpoint, as a host array in its
    own type (bf16 as ml_dtypes' bfloat16)."""
    obj = torch.load(path, map_location="cpu", weights_only=True,
                     mmap=True)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    for k in keys:
        obj = obj[k]
    return to_host(obj.detach())


def load_pth_lazy(path: str) -> Dict[str, "object"]:
    """{name: LazyWeight} with byte-span origin metadata, for
    WeightStorage.origin_reference() exports that point back at this
    .pth file (reference OriginReferenceOutputManager pth branch,
    onnx_graph/weights.rs:250-261 + 300-364: external_data carries
    format/tensor_name/location/offset/length). Nested dicts flatten to
    dotted names; a tensor that is not dense row-major carries no
    origin."""
    from ..symbolic_graph.tensor_store import ExternalBinary
    from .onnx_builder import LazyWeight

    abs_path = os.path.abspath(path)
    storages: Dict[str, _Storage] = {}
    with zipfile.ZipFile(path) as zf:
        pkl_name = next(n for n in zf.namelist() if n.endswith("data.pkl"))
        root = pkl_name[: -len("data.pkl")]
        result = _RefUnpickler(zf.read(pkl_name), storages).load()
        data_off = {key: _zip_data_offset(zf, f"{root}data/{key}")
                    for key in storages}

    out: Dict[str, object] = {}

    def walk(keys: Tuple[Any, ...], obj) -> None:
        if isinstance(obj, _TensorRef):
            itemsize = int(obj.storage.dtype.size_bytes)
            numel = int(np.prod(obj.shape, dtype=np.int64))
            expect, dense = 1, True
            for d, s in zip(reversed(obj.shape), reversed(obj.strides)):
                dense = dense and (s == expect or d == 1)
                expect *= d
            name = ".".join(str(k) for k in keys)
            if dense:
                span = ExternalBinary(
                    abs_path, data_off[obj.storage.key] + obj.offset * itemsize,
                    numel * itemsize, obj.storage.dtype, obj.shape)
                out[name] = LazyWeight(
                    lambda s=span: s.load().numpy(), span.dtype, span.shape,
                    origin={"format": "pth", "tensor_name": name,
                            "location": abs_path, "offset": span.offset,
                            "length": span.length})
            else:
                out[name] = LazyWeight(lambda k=keys: _take(abs_path, k),
                                       obj.storage.dtype, obj.shape)
        elif isinstance(obj, dict):
            for k, v in obj.items():
                walk(keys + (k,), v)

    if isinstance(result, dict) and isinstance(
            result.get("state_dict"), dict):
        result = result["state_dict"]
    walk((), result)
    return out

"""BCL ObjectContainers (paper section 6), PyTorch port.

Elements are stored as fixed-width u32 lane matrices ``(N, L)``, the
unit every container and the exchange engine moves; here the lanes are
int32 bit-views (see :mod:`repro_torch.core.u32`).  Element types are
described by :class:`Spec` (a shape plus a torch or numpy dtype) in
place of ``jax.ShapeDtypeStruct``:

  * a single 32-bit field packs by a bit-view (copy elision);
  * a struct (dict of fields) packs each field to lanes and
    concatenates them in sorted field order.

Users with custom types subclass :class:`Packer`.
"""

from __future__ import annotations

import abc
from typing import Any, NamedTuple

import numpy as np
import torch

_I32 = torch.int32


class Spec(NamedTuple):
    """Per-element shape (``()`` or ``(inner,)``) and dtype of a field."""

    shape: tuple
    dtype: Any


def torch_dtype(dtype) -> torch.dtype:
    """Normalize a torch or numpy dtype (or type) to a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def _itemsize(dtype) -> int:
    return torch.empty(0, dtype=torch_dtype(dtype)).element_size()


def _lanes_for_dtype(dtype) -> int:
    """u32 lanes needed per scalar of ``dtype``."""
    size = _itemsize(dtype)
    if size <= 4:
        return 1
    if size == 8:
        return 2
    raise TypeError(f"unsupported element dtype {dtype}")


def as_tensor(x) -> torch.Tensor:
    """Accept numpy arrays where tensors are expected."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return x


def _to_u32(x: torch.Tensor) -> torch.Tensor:
    """Bit-view any <=32-bit tensor (N,) or (N, d) as u32 lanes (N, d')."""
    x = as_tensor(x)
    if x.ndim == 1:
        x = x[:, None]
    size = x.element_size()
    if x.dtype == _I32:
        return x
    if size == 4:
        return x.contiguous().view(_I32)
    if x.dtype == torch.bool:
        return x.to(_I32)
    if size == 2:
        return x.contiguous().view(torch.int16).to(_I32) & 0xFFFF
    if size == 1:
        return x.contiguous().view(torch.uint8).to(_I32)
    raise TypeError(f"unsupported dtype {x.dtype}")


def _from_u32(lanes: torch.Tensor, dtype, inner: int) -> torch.Tensor:
    """Invert :func:`_to_u32` back to ``dtype`` with trailing dim ``inner``."""
    dt = torch_dtype(dtype)
    size = _itemsize(dt)
    lanes = lanes.contiguous()
    if size == 4:
        out = lanes.view(dt)
    elif dt == torch.bool:
        out = lanes != 0
    elif size == 2:
        low = lanes & 0xFFFF
        out = torch.where(low >= 1 << 15, low - (1 << 16), low).to(torch.int16).view(dt)
    elif size == 1:
        out = (lanes & 0xFF).to(torch.uint8).view(dt)
    else:
        raise TypeError(f"unsupported dtype {dt}")
    if inner == 0:
        return out[:, 0]
    return out


def ragged_offsets(widths) -> tuple[list[int], int]:
    """Word offsets of back-to-back ragged segments.

    Returns ``(starts, total)`` where ``starts[f]`` is the first word of
    segment ``f`` and ``total`` the words per destination block; the
    fused wire gives flow ``f`` a segment of ``C_f * widths[f]`` words.
    """
    starts, off = [], 0
    for w in widths:
        starts.append(off)
        off += int(w)
    return starts, off


def scatter_rows(flat: torch.Tensor, base: torch.Tensor, rows: torch.Tensor,
                 widths: torch.Tensor | None = None) -> torch.Tensor:
    """Pack (N, W) u32 rows into a copy of a flat word buffer.

    Row ``i`` lands at words ``[base[i], base[i] + W)``; words at or past
    ``flat.numel()`` drop.  With ``widths`` (per-row word counts <= W)
    lanes past ``widths[i]`` drop too.  The plain oracle of the
    ``pack_rows``/``place_rows`` kernels, as in
    ``repro.core.object_container.scatter_rows``.
    """
    total = flat.shape[0]
    w = rows.shape[1]
    lane = torch.arange(w, dtype=torch.int64, device=flat.device)[None, :]
    idx = base.to(torch.int64)[:, None] + lane
    keep = (idx >= 0) & (idx < total)
    if widths is not None:
        keep &= lane < widths.to(torch.int64)[:, None]
    out = flat.clone()
    out[idx[keep]] = _to_u32(rows)[keep]
    return out


class Packer(abc.ABC):
    """Serialize a record <-> a fixed-width u32 lane matrix."""

    #: static number of u32 lanes per element
    lanes: int

    @abc.abstractmethod
    def pack(self, value: Any) -> torch.Tensor:
        """(record of (N, ...) tensors) -> (N, lanes) int32 words."""

    @abc.abstractmethod
    def unpack(self, mat: torch.Tensor) -> Any:
        """(N, lanes) int32 words -> record of (N, ...) tensors."""


class IdentityPacker(Packer):
    """Copy-elision fast path: a single 32-bit field, packed by bit-view."""

    def __init__(self, dtype, inner: int = 0):
        self.dtype = torch_dtype(dtype)
        self.inner = inner  # 0 => scalar field (N,), else (N, inner)
        if _itemsize(self.dtype) != 4:
            raise TypeError("IdentityPacker requires a 32-bit dtype")
        self.lanes = max(inner, 1)

    def pack(self, value) -> torch.Tensor:
        return _to_u32(value)

    def unpack(self, mat: torch.Tensor) -> torch.Tensor:
        return _from_u32(mat, self.dtype, self.inner)


class StructPacker(Packer):
    """Fixed-size struct: dict of named fields, each <=32-bit scalar/vector."""

    def __init__(self, fields: dict[str, Spec]):
        self.fields = dict(sorted(fields.items()))
        self.layout: list[tuple[str, Any, int, int]] = []  # name,dtype,inner,lanes
        off = 0
        for name, sds in self.fields.items():
            if len(sds.shape) > 1:
                raise TypeError(f"field {name}: per-element shape must be scalar/vector")
            inner = sds.shape[0] if sds.shape else 0
            width = max(inner, 1) * _lanes_for_dtype(sds.dtype)
            if _itemsize(sds.dtype) == 8:
                raise TypeError(
                    f"field {name}: 64-bit fields unsupported; "
                    "split into two u32 fields")
            self.layout.append((name, sds.dtype, inner, width))
            off += width
        self.lanes = off

    def pack(self, value: dict) -> torch.Tensor:
        return torch.cat([_to_u32(value[name]) for name, *_ in self.layout], dim=1)

    def unpack(self, mat: torch.Tensor) -> dict:
        out = {}
        off = 0
        for name, dtype, inner, width in self.layout:
            out[name] = _from_u32(mat[:, off:off + width], dtype, inner)
            off += width
        return out


def packer_for(spec: Any) -> Packer:
    """Pick the cheapest packer for ``spec``.

    ``spec`` is a :class:`Spec` (single field), a dict of them (struct),
    an int (u32 vector of that many lanes), an example tensor or array,
    or an existing Packer (passed through).
    """
    if isinstance(spec, Packer):
        return spec
    if isinstance(spec, int):
        return IdentityPacker(torch.uint32, inner=spec if spec > 1 else 0)
    if isinstance(spec, Spec):
        inner = spec.shape[0] if spec.shape else 0
        if _itemsize(spec.dtype) == 4:
            return IdentityPacker(spec.dtype, inner)
        return StructPacker({"value": spec})
    if isinstance(spec, dict):
        return StructPacker(spec)
    if hasattr(spec, "dtype") and hasattr(spec, "shape"):
        inner = spec.shape[1] if len(spec.shape) > 1 else 0
        return packer_for(Spec((inner,) if inner else (), spec.dtype))
    raise TypeError(f"cannot derive a Packer for {spec!r}")

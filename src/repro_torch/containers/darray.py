"""BCL::DArray, a distributed 1-D array (paper Table 1), PyTorch port.

Block layout: global element g lives on rank ``g // local_n`` at local
offset ``g % local_n``.  ``rget``/``rput`` are the one-sided read/write
primitives: batches of global indices are routed to owners, served
locally, and (for rget) routed back, at cost R / W per element.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import costs
from repro_torch.core.backend import Backend
from repro_torch.core.exchange import reply, route
from repro_torch.core.object_container import Packer, packer_for
from repro_torch.core.u32 import as_u64, to_i32

_I32 = torch.int32
_I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class DArraySpec:
    global_n: int
    local_n: int
    packer: Packer

    @property
    def lanes(self) -> int:
        return self.packer.lanes


class DArrayState(NamedTuple):
    local: torch.Tensor  # (local_n, L) int32 words


def darray_create(backend: Backend, global_n: int, value_spec,
                  device="cuda") -> tuple[DArraySpec, DArrayState]:
    """Collective constructor; the shards live on ``device``."""
    packer = packer_for(value_spec)
    nprocs = backend.nprocs()
    if global_n % nprocs:
        global_n += nprocs - global_n % nprocs
    local_n = global_n // nprocs
    spec = DArraySpec(global_n, local_n, packer)
    return spec, DArrayState(torch.zeros((local_n, packer.lanes), dtype=_I32,
                                         device=device))


def owner_of(spec: DArraySpec, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    idx = idx.to(_I32)
    return idx // spec.local_n, idx % spec.local_n


def rget(backend: Backend, spec: DArraySpec, state: DArrayState,
         idx: torch.Tensor, capacity: int):
    """Batched one-sided read of global indices. Returns (values, found)."""
    n = idx.shape[0]
    owner, off = owner_of(spec, idx)
    req = route(backend, off[:, None], owner, capacity, op_name="darray.rget")
    loff = torch.where(req.valid, req.payload[:, 0], 0).to(_I64)
    out, answered = reply(backend, req, state.local[loff], n, op_name="darray.rget")
    costs.record("darray.rget", costs.Cost(R=n))
    return spec.packer.unpack(out), answered


def rput(backend: Backend, spec: DArraySpec, state: DArrayState,
         idx: torch.Tensor, values, capacity: int, mode: str = "set"):
    """Batched one-sided write. mode='set'|'add' (wrapping u32). Returns
    the new state."""
    n = idx.shape[0]
    owner, off = owner_of(spec, idx)
    lanes = spec.packer.pack(values)
    res = route(backend, torch.cat([off[:, None], lanes], dim=1), owner, capacity,
                op_name="darray.rput")
    loff = res.payload[:, 0].to(_I64)
    keep = res.valid & (loff >= 0) & (loff < spec.local_n)
    rows = res.payload[:, 1:]
    if mode == "add":
        acc = as_u64(state.local).index_add_(0, loff[keep], as_u64(rows[keep]))
        local = to_i32(acc)
    else:
        local = state.local.clone()
        local[loff[keep]] = rows[keep]
    costs.record("darray.rput", costs.Cost(W=n))
    return DArrayState(local)


def local_read(spec: DArraySpec, state: DArrayState, off: torch.Tensor):
    return spec.packer.unpack(state.local[off.to(_I64)])


def local_write(spec: DArraySpec, state: DArrayState, off: torch.Tensor, values):
    local = state.local.clone()
    local[off.to(_I64)] = spec.packer.pack(values)
    return DArrayState(local)


def to_global(backend: Backend, spec: DArraySpec, state: DArrayState):
    """All-gather the full array (testing/debug; cost nR)."""
    shards = backend.all_gather(state.local)          # (P, local_n, L)
    return spec.packer.unpack(shards.reshape(-1, spec.packer.lanes))

"""Port foundations against the JAX package: hashing, packers, wire
helpers, costs, promises, backends, and the port's import boundary.

Inputs come from a numpy seed and go through both packages; every
result is integer and must match bit for bit (tolerance 0).
"""

import ast
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import ShapeDtypeStruct as SDS

from repro.core import costs as jcosts
from repro.core import hashing as jh
from repro.core import object_container as joc
from repro.core import promises as jprom
from repro_torch.core import costs as tcosts
from repro_torch.core import hashing as th
from repro_torch.core import object_container as toc
from repro_torch.core import promises as tprom
from repro_torch.core.backend import SerialBackend
from repro_torch.core.pointers import GlobalPointer, from_global_index, global_index
from repro_torch.core.u32 import as_u64, mul32, to_i32
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _np(t):
    """Port int32 words -> u32 numpy."""
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fmix32_and_hash_u32_bit_exact(seed):
    x = _u32(np.random.default_rng(seed), (4096,))
    x[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    assert np.array_equal(np.asarray(jh.fmix32(jnp.asarray(x))),
                          _np(th.fmix32(torch.from_numpy(x))))
    assert np.array_equal(np.asarray(jh.hash_u32(jnp.asarray(x), seed)),
                          _np(th.hash_u32(torch.from_numpy(x), seed)))


@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1, 3])
def test_hash_lanes_bit_exact(lanes, seed):
    x = _u32(np.random.default_rng(lanes * 10 + seed), (2048, lanes))
    want = np.asarray(jh.hash_lanes(jnp.asarray(x), seed))
    assert np.array_equal(want, _np(th.hash_lanes(torch.from_numpy(x), seed)))
    if lanes == 1:   # the 1-D form is one lane
        assert np.array_equal(want, _np(th.hash_lanes(torch.from_numpy(x[:, 0]), seed)))


@pytest.mark.parametrize("k,modulo", [(1, 64), (3, 1000), (5, 1 << 20), (2, (1 << 32) - 5)])
def test_double_hash_bit_exact(k, modulo):
    x = _u32(np.random.default_rng(k), (1024, 2))
    want = np.asarray(jh.double_hash(jnp.asarray(x), k, modulo))
    assert np.array_equal(want, _np(th.double_hash(torch.from_numpy(x), k, modulo)))


def test_u32_helpers_wrap():
    a = torch.tensor([0, 1, -1, -(1 << 31)], dtype=torch.int32)
    u = as_u64(a)
    assert u.tolist() == [0, 1, (1 << 32) - 1, 1 << 31]
    assert torch.equal(to_i32(u), a)
    assert mul32(u, 0xFFFFFFFF).tolist() == [(v * 0xFFFFFFFF) % (1 << 32) for v in u.tolist()]


PACK_CASES = [
    ("u32", SDS((), jnp.uint32), toc.Spec((), torch.uint32), np.uint32, ()),
    ("u32x3", SDS((3,), jnp.uint32), toc.Spec((3,), np.uint32), np.uint32, (3,)),
    ("i32", SDS((), jnp.int32), toc.Spec((), torch.int32), np.int32, ()),
    ("f32x2", SDS((2,), jnp.float32), toc.Spec((2,), np.float32), np.float32, (2,)),
    ("i16", SDS((), jnp.int16), toc.Spec((), torch.int16), np.int16, ()),
    ("u8x4", SDS((4,), jnp.uint8), toc.Spec((4,), np.uint8), np.uint8, (4,)),
]


def _values(rng, dtype, shape, n=257):
    if np.issubdtype(dtype, np.floating):
        return rng.standard_normal((n, *shape)).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, (n, *shape), dtype=np.int64).astype(dtype)


@pytest.mark.parametrize("name,jspec,tspec,dtype,shape", PACK_CASES,
                         ids=[c[0] for c in PACK_CASES])
def test_packer_for_matches_jax(name, jspec, tspec, dtype, shape):
    x = _values(np.random.default_rng(len(name)), dtype, shape)
    jp, tp = joc.packer_for(jspec), toc.packer_for(tspec)
    assert jp.lanes == tp.lanes
    assert type(jp).__name__ == type(tp).__name__
    struct = isinstance(tp, toc.StructPacker)   # sub-32-bit fields: {"value": x}
    wrap = (lambda v: {"value": v}) if struct else (lambda v: v)
    lanes = tp.pack(wrap(torch.from_numpy(x)))
    assert np.array_equal(np.asarray(jp.pack(wrap(jnp.asarray(x)))), _np(lanes))
    back = tp.unpack(lanes)
    assert np.array_equal((back["value"] if struct else back).numpy(), x)


def test_struct_packer_matches_jax():
    rng = np.random.default_rng(3)
    cols = {"a": _values(rng, np.uint32, ()), "b": _values(rng, np.float32, (2,)),
            "c": _values(rng, np.int16, ())}
    jfields = {"a": SDS((), jnp.uint32), "b": SDS((2,), jnp.float32),
               "c": SDS((), jnp.int16)}
    tfields = {"a": toc.Spec((), np.uint32), "b": toc.Spec((2,), np.float32),
               "c": toc.Spec((), np.int16)}
    jp, tp = joc.packer_for(jfields), toc.packer_for(tfields)
    lanes = tp.pack({k: torch.from_numpy(v) for k, v in cols.items()})
    assert np.array_equal(np.asarray(jp.pack({k: jnp.asarray(v) for k, v in cols.items()})),
                          _np(lanes))
    back = tp.unpack(lanes)
    assert all(np.array_equal(back[k].numpy(), cols[k]) for k in cols)
    assert toc.packer_for(4).lanes == joc.packer_for(4).lanes == 4
    with pytest.raises(TypeError):
        toc.packer_for({"x": toc.Spec((), np.int64)})


def test_ragged_offsets_matches_jax():
    for widths in ([], [3], [4, 1, 7], [0, 5, 0, 2]):
        assert toc.ragged_offsets(widths) == joc.ragged_offsets(widths)


@pytest.mark.parametrize("chunk_words", [1 << 25, 9], ids=["one_chunk", "two_rows_a_chunk"])
@pytest.mark.parametrize("with_widths", [False, True])
def test_scatter_rows_matches_jax(with_widths, chunk_words, monkeypatch):
    """Also when the rows are placed a few at a time (the plain version
    bounds its index arrays on wide MoE waves)."""
    monkeypatch.setattr(toc, "_SCATTER_WORDS", chunk_words)
    rng = np.random.default_rng(5)
    total, n, w = 200, 60, 4
    flat = _u32(rng, (total,))
    base = rng.permutation(total + 40)[:n].astype(np.int32)
    rows = _u32(rng, (n, w))
    widths = rng.integers(0, w + 1, n).astype(np.int32) if with_widths else None
    want = joc.scatter_rows(jnp.asarray(flat), jnp.asarray(base), jnp.asarray(rows),
                            None if widths is None else jnp.asarray(widths))
    got = toc.scatter_rows(torch.from_numpy(flat.view(np.int32)), torch.from_numpy(base),
                           torch.from_numpy(rows.view(np.int32)),
                           None if widths is None else torch.from_numpy(widths))
    assert np.array_equal(np.asarray(want), _np(got))


def test_costs_match_jax():
    fields = [f.name for f in jcosts.Cost.__dataclass_fields__.values()]
    assert fields == [f.name for f in tcosts.Cost.__dataclass_fields__.values()]
    assert len(fields) == 14
    vals = {f: i + 1 for i, f in enumerate(fields)}
    jc, tc = jcosts.Cost(**vals), tcosts.Cost(**vals)
    assert (jc + jc).__dict__ == (tc + tc).__dict__
    assert jc.formula() == tc.formula()
    with tcosts.recording() as log:
        tcosts.record("a", tc)
        tcosts.record("b", tc)
        tcosts.record("a", tc)
    assert log.by_op("a").__dict__ == (jc + jc).__dict__
    assert log.total().A == 3


def test_promises_match_jax():
    assert [p.name for p in tprom.Promise] == [p.name for p in jprom.Promise]
    assert int(tprom.ConProm.HashMap.find_insert) == int(jprom.ConProm.HashMap.find_insert)
    for p in (tprom.Promise.FIND, tprom.Promise.FIND | tprom.Promise.INSERT,
              tprom.Promise.LOCAL, tprom.Promise.PUSH | tprom.Promise.POP):
        jp = jprom.Promise(int(p))
        for fn in ("fine_grained", "fully_atomic_hashmap", "find_only", "local_only",
                   "fully_atomic_queue"):
            assert getattr(tprom, fn)(p) == getattr(jprom, fn)(jp)
    with pytest.raises(ValueError):
        tprom.validate(tprom.Promise.FINE | tprom.Promise.LOCAL)


def test_serial_backend_and_pointers():
    bk = SerialBackend()
    x = torch.arange(6, dtype=torch.int32)
    assert torch.equal(bk.tiled_all_to_all(x), x)
    assert bk.all_gather(x).shape == (1, 6)
    off, tot = bk.exclusive_rank_offsets(torch.tensor(5))
    assert (int(off), int(tot)) == (0, 5)
    # single-member sub-axis groups are the identity, as in the JAX package
    assert torch.equal(bk.tiled_all_to_all(x, groups=[[0]]), x)
    assert torch.equal(bk.tiled_all_to_all_wait(bk.tiled_all_to_all_start(x)), x)
    p = from_global_index(torch.tensor([0, 9, 17]), 8)
    assert p.rank.tolist() == [0, 1, 2] and p.offset.tolist() == [0, 1, 1]
    assert global_index(p + 1, 8).tolist() == [1, 10, 18]
    assert GlobalPointer.null((2,), device="cpu").is_null().all()


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_profile_hashmap.py",
                 ROOT / "scripts" / "torch_flash_ab.py", ROOT / "scripts" / "torch_scan_ab.py",
                 ROOT / "scripts" / "kernel_ab.py", ROOT / "scripts" / "torch_gloo_probe.py",
                 ROOT / "examples" / "torch_quickstart.py",
                 ROOT / "examples" / "torch_isx_sort.py",
                 ROOT / "examples" / "torch_genome_assembly.py"])


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    """The port stands alone: no module of it imports JAX or the JAX package."""
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_leave_jax_and_repro_unloaded():
    """Importing every module of the port (and chip_smoke.py's imports) in a
    fresh interpreter loads neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 20 else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

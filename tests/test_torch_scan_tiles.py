"""The recurrent scans' kernel algorithms, emulated in torch on the CPU.

``csrc/ssm_scan.cu`` runs only on the card.  ``emulate_mamba`` repeats
the chunked route of ``mamba_scan`` (``mamba_ssd_kernel``): T cut into
chunks of ``kL`` steps (read from the source), zero-filled past T; the
chunk-local running sum ``cs`` of ``a dt`` taken in step order; ``G = C
B^T`` once a chunk for all heads; ``M = G exp(cs[i] - cs[j]) dt[j]`` with
the mask applied before ``exp``; ``Y = exp(cs) (C h) + M X``; the state
carried from chunk to chunk as ``h exp(cs[L-1]) + B^T (W X)`` with ``W =
exp(cs[L-1] - cs) dt``; and every product in 3xTF32, each operand split
into ``hi`` (x rounded to TF32 as ``cvt.rna`` rounds, on the bits) and
``lo = x - hi`` (of which the tensor cores read the top 19 bits), summed
as ``lo*hi + hi*lo + hi*hi``.  The parts that do not carry the state run
for all chunks at once.  ``emulate_rwkv`` repeats ``rwkv_scan_kernel``:
the state updates rounded as the plain step rounds them, each value
column's sum over k split among ``kQ`` threads (thread q the rows ``q K/4
+ 4 m + e``, in two chains of fused multiply-adds, even and odd ``m``), the
partial sums combined as ``(q0 + q1) + (q2 + q3)``, and the bonus ``u k
v`` factored out as ``v sum_k r u k``, that sum taken by ``K / 8`` threads
of 8 rows and a shuffle tree.

Both are held against ``mamba_scan_plain`` / ``rwkv_scan_plain`` at
``chip_smoke.SCAN_REL_L2`` (1e-5 relative L2) on the output and the final
state; RWKV's state bit for bit.  A one-TF32-pass control breaks that gate
(2.5e-4 at five chunks), and each of ``chip_smoke.SCAN_FAULTS``' planted
faults breaks it by ``chip_smoke.FAULT_FACTOR``.  Inputs come from numpy
with a seed.  Run as a script, it prints the largest gaps of every case
with three TF32 passes and with one.
"""

import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the gate and the planted faults)
from repro_torch.kernels import ssm_scan  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread)

SRC = (Path(ssm_scan.__file__).parents[1] / "csrc" / "ssm_scan.cu").read_text()
L = int(re.search(r"constexpr int kL = (\d+);", SRC).group(1))          # steps a chunk
Q = int(re.search(r"constexpr int kQ = (\d+);", SRC).group(1))          # threads a column
GATE = chip_smoke.SCAN_REL_L2


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds (10 mantissa bits, to
    nearest, ties away from zero): add half of the dropped 13 bits, clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) as the tensor cores see them: lo = x - hi, its low 13 bits dropped."""
    hi = tf32(x)
    lo = (x - hi).contiguous().view(torch.int32)
    return hi, (lo & ~0x1FFF).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b on the tensor cores: three TF32 passes (small terms first), or one."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def emulate_mamba(x, dt, b, c, a, h0, passes: int = 3):
    """x (B,T,H,P), dt (B,T,H), b/c (B,T,S), a (H,), h0 (B,H,S,P) -> (y, h)
    as the chunked route computes them."""
    nb, t, nh, p = x.shape
    nc = -(-t // L)

    def chunks(z):                      # (B, T, ...) -> (B, nc, L, ...), zeros past T
        z = torch.cat([z, z.new_zeros((nb, nc * L - t, *z.shape[2:]))], 1)
        return z.reshape(nb, nc, L, *z.shape[2:])

    xc, dtc, bc, cc = chunks(x), chunks(dt), chunks(b), chunks(c)
    dth = dtc.permute(0, 1, 3, 2)                                   # (B,nc,H,L)
    steps = a[:, None] * dth                                        # a dt, rounded
    cs = torch.empty_like(steps)
    run = torch.zeros_like(steps[..., 0])
    for j in range(L):                                              # in step order
        run = run + steps[..., j]
        cs[..., j] = run
    last = cs[..., -1:]                                             # (B,nc,H,1)
    w = torch.exp(last - cs) * dth                                  # W (B,nc,H,L)
    e = torch.exp(cs)
    g = product(cc, bc.transpose(-1, -2), passes)                   # (B,nc,L,L): all heads
    below = torch.tril(torch.ones(L, L, dtype=torch.bool))
    expo = torch.where(below, cs[..., :, None] - cs[..., None, :], -math.inf)
    m = g[:, :, None] * (torch.exp(expo) * dth[..., None, :])       # (B,nc,H,L,L)
    xh = xc.permute(0, 1, 3, 2, 4)                                  # (B,nc,H,L,P)
    ydiag = product(m, xh, passes)
    wx_t = (w[..., None] * xh).transpose(-1, -2)                    # (W X)^T (B,nc,H,P,L)
    h, ys = h0, []
    for ci in range(nc):
        yoff = product(cc[:, ci, None], h, passes)                  # C h (B,H,L,P)
        ys.append(yoff * e[:, ci, :, :, None] + ydiag[:, ci])
        h_t = h.transpose(-1, -2) * torch.exp(last[:, ci, :, :, None])
        h = (h_t + product(wx_t[:, ci], bc[:, ci, None], passes)).transpose(-1, -2)
    y = torch.stack(ys, 1).permute(0, 1, 3, 2, 4).reshape(nb, nc * L, nh, p)[:, :t]
    return y, h


def _fma(x, y, z):
    """fmaf: the exact product plus z, rounded once (in float64, then to float32)."""
    return (x.double() * y.double() + z.double()).float()


def emulate_rwkv(r, k, v, w, u, s0):
    """r/k/v/w (B,T,H,K), u (H,K), s0 (B,H,K,K) -> (out, s) as
    rwkv_scan_kernel computes them."""
    nb, t, nh, kd = r.shape
    states, s = [], s0
    for i in range(t):                  # the state before each step, rounded as the plain step
        states.append(s)
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        s = w[:, i, :, :, None] * s + kv
    before = torch.stack(states, 1)                                 # (B,T,H,K,V)
    # thread (q, v) owns rows q K/4 + 4 m + e, walked m-major; chains by m parity
    part = torch.zeros((2, nb, t, nh, Q, kd))
    for m in range(kd // 16):
        for e in range(4):
            rows = [q * (kd // Q) + 4 * m + e for q in range(Q)]
            part[m & 1] = _fma(r[..., rows, None], before[..., rows, :], part[m & 1])
    sums = part[0] + part[1]                                        # (B,T,H,Q,V)
    col = (sums[..., 0, :] + sums[..., 1, :]) + (sums[..., 2, :] + sums[..., 3, :])
    # the bonus sums: kd / 8 threads a step, 8 rows each, then xor shuffles
    ru = r * u
    per = kd // 8
    acc = torch.zeros((nb, t, nh, per))
    for e in range(8):
        rows = [8 * pp + e for pp in range(per)]
        acc = _fma(ru[..., rows], k[..., rows], acc)
    off = per // 2
    while off:
        acc = acc + acc[..., [pp ^ off for pp in range(per)]]
        off //= 2
    return _fma(v, acc[..., :1], col), s


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def mamba_inputs(seed, nb, t, nh, p, s, decay, state):
    """x, B, C as slices of one SiLU'd conv output; dt = softplus(.);
    decay "strong": a dt down to -30 a step; "weak": down to -1e-2."""
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((nb, t, nh * p + 2 * s)).astype(np.float32)
    conv = torch.from_numpy(conv)
    conv = conv * torch.sigmoid(conv)
    x = conv[..., :nh * p].reshape(nb, t, nh, p)
    b, c = conv[..., nh * p:nh * p + s], conv[..., nh * p + s:]
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((nb, t, nh)).astype(np.float32)))
    top = 30.0 if decay == "strong" else 1e-2
    a = -torch.from_numpy(rng.uniform(0.05, 1.0, nh).astype(np.float32)) * top / dt.max()
    h0 = (torch.from_numpy(rng.standard_normal((nb, nh, s, p)).astype(np.float32))
          if state else torch.zeros((nb, nh, s, p)))
    return x, dt, b, c, a, h0


MAMBA_CASES = [(1, "weak", True), (L - 1, "strong", True), (L, "weak", False),
               (L + 1, "strong", False), (5 * L + 7, "weak", True), (5 * L + 7, "strong", True),
               (2048, "weak", True), (2048, "strong", False)]


@pytest.mark.parametrize("t,decay,state", MAMBA_CASES)
def test_mamba_chunks_match_plain(t, decay, state):
    """The chunk decomposition in 3xTF32 against the plain loop: output and
    final state within the card's gate, from a zero or a random state, at
    strong and weak decays, T = 1 (one partial chunk), L - 1, L, L + 1 and
    many chunks."""
    args = mamba_inputs(t, 2, t, 3, 16, 16, decay, state)
    y, h = emulate_mamba(*args)
    want_y, want_h = ssm_scan.mamba_scan_plain(*args)
    assert y.shape == want_y.shape and h.shape == want_h.shape
    assert _rel(y, want_y) <= GATE and _rel(h, want_h) <= GATE, (_rel(y, want_y), _rel(h, want_h))


def test_mamba_controls_break_the_gate():
    """One TF32 pass misses the gate (by ~25x); each planted fault of
    chip_smoke.py by FAULT_FACTOR, on a many-chunk call."""
    args = mamba_inputs(7, 2, 5 * L + 7, 3, 16, 16, "weak", True)
    want = ssm_scan.mamba_scan_plain(*args)
    one = emulate_mamba(*args, passes=1)
    assert max(_rel(g, w) for g, w in zip(one, want)) > GATE
    for plant in chip_smoke.SCAN_FAULTS["mamba_scan"].values():
        got = plant(emulate_mamba)(*args)
        assert max(_rel(g, w) for g, w in zip(got, want)) > chip_smoke.FAULT_FACTOR * GATE


def rwkv_inputs(seed, nb, t, nh, k, state):
    """r, k, v normal; w = exp(-exp(-5 + N(0, 1))) as RWKV-6's decay at its init."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    r, key, v = normal(nb, t, nh, k), normal(nb, t, nh, k), normal(nb, t, nh, k)
    w = torch.exp(-torch.exp(-5 + normal(nb, t, nh, k)))
    u = 0.1 * normal(nh, k)
    s0 = normal(nb, nh, k, k) if state else torch.zeros((nb, nh, k, k))
    return r, key, v, w, u, s0


@pytest.mark.parametrize("t,k,state", [(1, 64, True), (31, 16, False), (33, 32, True),
                                       (2048, 16, True)])
def test_rwkv_split_sums_match_plain(t, k, state):
    """The split partial sums in the kernel's combine order: output within
    the gate, the final state bit for bit."""
    args = rwkv_inputs(t + k, 2, t, 2, k, state)
    out, s = emulate_rwkv(*args)
    want_out, want_s = ssm_scan.rwkv_scan_plain(*args)
    assert torch.equal(s, want_s)
    assert out.shape == want_out.shape and _rel(out, want_out) <= GATE


def test_rwkv_faults_break_the_gate():
    args = rwkv_inputs(3, 2, 70, 2, 32, True)
    want = ssm_scan.rwkv_scan_plain(*args)
    for plant in chip_smoke.SCAN_FAULTS["rwkv_scan"].values():
        got = plant(emulate_rwkv)(*args)
        assert max(_rel(g, w) for g, w in zip(got, want)) > chip_smoke.FAULT_FACTOR * GATE


def test_mamba_routes_and_shared_memory():
    """The wrapper's route by shape: the chunked route from one chunk of
    steps on, two heads a CTA where H is even and their warps fit, else
    one; the sequential route below a chunk (decode) and for heads the
    chunked kernel's warps do not cover.  Every layout it picks fits the
    shared memory."""
    assert ssm_scan.SSD_CHUNK == L
    assert int(re.search(r"constexpr int kMaxWarps = (\d+);", SRC).group(1)) == \
        ssm_scan.SSD_MAX_WARPS
    assert ssm_scan.mamba_route(2048, 112, 64, 64) == 2      # zamba2-7b
    assert ssm_scan.mamba_route(1, 112, 64, 64) == 0         # its decode
    assert ssm_scan.mamba_route(L - 1, 4, 64, 64) == 0
    assert ssm_scan.mamba_route(L, 2, 64, 16) == 2           # the reduced zamba2-7b
    assert ssm_scan.mamba_route(40, 5, 7, 64) == 1           # H odd
    assert ssm_scan.mamba_route(70, 2, 128, 128) == 1        # 8 warps a head
    assert ssm_scan.mamba_route(70, 2, 256, 64) == 0         # past 8 warps
    for s in ssm_scan.MAMBA_STATES:
        for p in (7, 16, 64, 128, 256):
            heads = ssm_scan.mamba_route(L, 2, p, s)
            if heads:
                assert ssm_scan._ssd_smem(s, heads, -(-p // 16)) <= 232448


@pytest.mark.parametrize("arch,n_waves,gen,prompt_len,want", [
    ("zamba2-7b", 2, 32, 2048, {"flash_attention": 26, "mamba_scan": 136,
                                "mamba_scan_seq": 4352}),
    ("zamba2-7b", 1, 4, 31, {"flash_attention": 13, "mamba_scan_seq": 340}),
    ("rwkv6-1.6b", 2, 32, 2048, {"rwkv_scan": 1584})])
def test_serving_launches_by_route(arch, n_waves, gen, prompt_len, want):
    """chip_smoke holds a serving cell to these launch counts: each Mamba2
    layer's prefill on the chunked kernel from one chunk of prompt on
    (zamba2-7b: 68 layers a wave), its decode steps on the sequential one."""
    cfg = chip_smoke.get_config(arch)
    assert chip_smoke.serving_launches(cfg, n_waves, gen, prompt_len) == want


def _meta(*shapes):
    return tuple(torch.empty(s, device="meta") for s in shapes)


@pytest.mark.parametrize("name,route,ops_ms,bytes_ms", [
    ("mamba_scan", "chunked", 0.20591, 0.29391),
    ("mamba_scan_seq", "sequential", 0.56091, 0.29391),
    ("rwkv_scan", "sequential", 0.16276, 0.20283)])
def test_scan_bounds(name, route, ops_ms, bytes_ms):
    """The scans' bounds at the recurrent cells' prefill calls: the bytes
    (operands read, outputs written once) against the operations of the
    route's form; the chunked route's products in three TF32 passes, the
    sequential forms' float32 operations as few as the function needs
    (RWKV: 5 a state element and step, the bonus 5 a step and k)."""
    if name == "rwkv_scan":
        args = _meta(*[(8, 2048, 32, 64)] * 4, (32, 64), (8, 32, 64, 64))
        outs = _meta((8, 2048, 32, 64), (8, 32, 64, 64))
    else:
        # x a slice of the conv output (8, 2048, 7296), as mamba_apply passes it
        args = _meta((8, 2048, 112, 64), (8, 2048, 112), (8, 2048, 64), (8, 2048, 64), (112,),
                     (8, 112, 64, 64))
        outs = _meta((8, 2048, 112, 64), (8, 112, 64, 64))
    got_ms, by = chip_smoke.scan_bound(name.removesuffix("_seq"), args, outs, route)
    assert by == ("operations" if ops_ms > bytes_ms else "bytes")
    assert got_ms == pytest.approx(max(ops_ms, bytes_ms), rel=1e-4)


if __name__ == "__main__":
    torch.set_num_threads(1)
    for t, decay, state in MAMBA_CASES:
        args = mamba_inputs(t, 2, t, 3, 16, 16, decay, state)
        want = ssm_scan.mamba_scan_plain(*args)
        gaps = {n: [_rel(g, w) for g, w in zip(emulate_mamba(*args, passes=n), want)]
                for n in (3, 1)}
        print(f"mamba T={t} {decay} state={state}: output / state relative L2, three "
              f"passes {gaps[3][0]:.2e} / {gaps[3][1]:.2e}, "
              f"one {gaps[1][0]:.2e} / {gaps[1][1]:.2e}")

#!/usr/bin/env python3
"""Two checkouts' recurrent scans on the same inputs, in turns, on one card.

    python3 scripts/torch_scan_ab.py ROOT_A [ROOT_B] [--rounds 1] [--reps 10] \
        [--case mamba_prefill ...]

The A B B A driver is ``kernel_ab.py``'s (its docstring says how the
checkouts are run).  The cases are the first mixer layer's calls of
``chip_smoke.py``'s recurrent cells: ``ssm_scan.mamba_scan`` at zamba2-7b's
prefill and decode calls (8 rows, T = 2048 and 1, 112 heads of 64, d_state
64; x, B and C strided slices of one conv output; a = -1, dt = softplus of
a normal draw, as at the model's init) and ``ssm_scan.rwkv_scan`` at
rwkv6-1.6b's (8 rows, 32 heads of 64; w = exp(-exp(-5 + N(0, 1)))), from a
fixed seed.  Each case's row has the kernel's time by CUDA events over
``--reps`` launches (after as many to warm the card), the kernel it
launched (the launch counter that moved), its output's and final state's
relative L2 gap to the plain version (and whether the states are equal),
and the wrapper's host microseconds a call (calls enqueued back to back).
At the decode calls a call's host time is split: the launch alone
(``Kernel.__call__`` on outputs made beforehand), the two output
allocations, the rest (the wrapper's checks), and the stream lookup
``torch.cuda.current_stream().cuda_stream`` beside the raw handle.
"""

from __future__ import annotations

import sys

from kernel_ab import host_us, main

# name -> (scan, rows, T, heads, head width, d_state)
CASES = {
    "mamba_prefill": ("mamba", 8, 2048, 112, 64, 64),
    "mamba_decode": ("mamba", 8, 1, 112, 64, 64),
    "rwkv_prefill": ("rwkv", 8, 2048, 32, 64, 64),
    "rwkv_decode": ("rwkv", 8, 1, 32, 64, 64),
}


def _inputs(name: str, seed: int):
    import torch
    import torch.nn.functional as F
    scan, nb, t, nh, p, s = CASES[name]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    if scan == "mamba":
        conv = F.silu(normal(nb, t, nh * p + 2 * s))
        x = conv[..., :nh * p].reshape(nb, t, nh, p)
        b, c = conv[..., nh * p:nh * p + s], conv[..., nh * p + s:]
        dt = F.softplus(normal(nb, t, nh))
        return x, dt, b, c, -torch.ones(nh, device="cuda"), 0.1 * normal(nb, nh, s, p)
    r, k, v = normal(nb, t, nh, p), normal(nb, t, nh, p), normal(nb, t, nh, p)
    w = torch.exp(-torch.exp(-5 + normal(nb, t, nh, p)))
    return r, k, v, w, 0.1 * normal(nh, p), 0.1 * normal(nb, nh, p, p)


def _launch_parts(mod, scan: str, args) -> dict:
    """A decode call's host time split: the launch alone, the allocations,
    the stream lookups."""
    import torch
    # the decode call's kernel: the sequential entry point (one entry point for
    # both routes before the routes were counted apart)
    kern = getattr(mod, "_MAMBA_SEQ", mod._MAMBA) if scan == "mamba" else mod._RWKV
    out = {}
    if scan == "mamba":
        x, dt, b, c, a, h0 = args
        nb, t, nh, p = x.shape
        y, h = torch.empty((nb, t, nh, p), device="cuda"), torch.empty_like(h0)
        call = [x, x.stride(0), x.stride(1), dt, b, c, b.stride(0), b.stride(1), a, h0, y, h,
                nb, t, nh, p, b.shape[-1]]
        out["alloc_us"] = host_us(lambda: (torch.empty((nb, t, nh, p), device="cuda"),
                                           torch.empty_like(h0)))
    else:
        r, k, v, w, u, s0 = args
        o, s = torch.empty_like(r), torch.empty_like(s0)
        extra = [1] if len(kern.argtypes) == 14 else []
        call = [r, k, v, w, u, s0, o, s, *r.shape[:3], r.shape[3], *extra]
        out["alloc_us"] = host_us(lambda: (torch.empty(r.shape, device="cuda"),
                                           torch.empty_like(s0)))
    out["launch_us"] = host_us(lambda: kern(*call))
    out["stream_object_us"] = host_us(lambda: torch.cuda.current_stream().cuda_stream)
    out["stream_raw_us"] = host_us(
        lambda: torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()))
    return out


def worker(cases: list[str], reps: int) -> dict:
    """Time ``cases`` with the ssm_scan found on ``sys.path``."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import ssm_scan as mod

    out = {}
    for i, name in enumerate(cases):
        scan = CASES[name][0]
        args = _inputs(name, 100 + i)
        kern = getattr(mod, f"{scan}_scan")
        plain = getattr(mod, f"{scan}_scan_plain")
        before = build.launch_counts()
        got, want = kern(*args), plain(*args)
        launched = [n for n, c in build.launch_counts().items() if c != before[n]]
        for _ in range(reps):            # warm: the card's clocks ramp up under load
            kern(*args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            kern(*args)
        end.record()
        torch.cuda.synchronize()
        row = dict(ms=start.elapsed_time(end) / reps, kernel=launched,
                   rel_l2=[float((g - w).norm() / w.norm()) for g, w in zip(got, want)],
                   state_equal=bool(torch.equal(got[1], want[1])),
                   wrapper_host_us=host_us(lambda: kern(*args)))
        if args[0].shape[1] == 1:
            row.update(_launch_parts(mod, scan, args))
            row["checks_us"] = row["wrapper_host_us"] - row["launch_us"] - row["alloc_us"]
        out[name] = row
    return out


if __name__ == "__main__":
    sys.exit(main(__file__, __doc__, CASES, worker, reps=10, rounds=1))

#!/usr/bin/env python3
"""Two checkouts' flash_attention kernels on the same inputs, in turns, on one card.

    python3 scripts/torch_flash_ab.py ROOT_A ROOT_B [--rounds 2] [--reps 50] \
        [--case f32_probs_bf16 ...]

The A B B A driver is ``kernel_ab.py``'s (its docstring says how the
checkouts are run).  Each case is one call of ``flash_attention`` on inputs
drawn from a fixed seed, timed by CUDA events over ``--reps`` launches
and by ``torch.profiler``'s device time of its kernel; the kernel's
output is checked against ``flash_attention_plain`` (max |difference|
printed).  Cases are ``chip_smoke.py``'s (``FLASH_FULL`` shapes and flags).
"""

from __future__ import annotations

import sys

from kernel_ab import main

# name -> (b, hq, hkv, tq, tk, d, causal, window, dtype, probs_bf16, V's real columns)
CASES = {
    "f32": (2, 16, 4, 777, 777, 128, True, 0, "float32", False, 128),
    "f32_probs_bf16": (2, 16, 4, 777, 777, 128, True, 0, "float32", True, 128),
    "deepseek_prefill": (8, 128, 128, 1024, 1024, 192, True, 0, "bfloat16", False, 128),
    "deepseek_prefill_probs_bf16": (8, 128, 128, 1024, 1024, 192, True, 0, "bfloat16", True,
                                    128),
}


def worker(cases: list[str], reps: int) -> dict:
    """Time ``cases`` with the flash_attention found on ``sys.path``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa

    out = {}
    for i, name in enumerate(cases):
        b, hq, hkv, tq, tk, d, causal, window, dtype, pb, dv = CASES[name]
        dtype = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
                   for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
        v[..., dv:] = 0

        def kern():
            return fa.flash_attention(q, k, v, causal=causal, window=window, probs_bf16=pb)
        got = kern()
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window, probs_bf16=pb)
        err = float((got.float() - want.float()).abs().max())
        del want
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            kern()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                kern()
            torch.cuda.synchronize()
        dev_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                     if ev.device_type == DeviceType.CUDA and "flash_fwd" in ev.key) / 1e3 / reps
        out[name] = dict(ms=start.elapsed_time(end) / reps, device_ms=dev_ms, max_abs_err=err)
        del q, k, v, got
    return out


if __name__ == "__main__":
    sys.exit(main(__file__, __doc__, CASES, worker, reps=50, rounds=2))

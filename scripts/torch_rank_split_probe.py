"""Whether splitting a layer over 4 model ranks changes its pieces' bits
on the card: bf16 flash at 4 of 16 heads (seamless-m4t-medium's D=64) and
8 of 32 (qwen3-4b's D=128) against all heads at once, causal and cross;
a column slice of a GEMM against the whole product's columns; the
row-parallel product (float32 partials summed, rounded once) against the
one-rank product; both against a float64 product rounded to bf16.  Each
line: the share of elements that differ, the relative L2 gap and the
largest per-row one.

    python3 scripts/torch_rank_split_probe.py
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build, ops  # noqa: E402


def cmp(a: torch.Tensor, b: torch.Tensor) -> dict:
    a, b = a.float(), b.float()
    return dict(unequal=round((a != b).float().mean().item(), 6),
                rel=(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item(),
                pos=(torch.linalg.vector_norm(a - b, dim=-1)
                     / torch.linalg.vector_norm(b, dim=-1)).max().item())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_rank_split_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    build.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    out = {}
    for name, (hq, d, t, s) in {"seamless": (16, 64, 2048, 512),
                                "qwen3": (32, 128, 2048, 2048)}.items():
        q, k, v = rnd(8, hq, t, d), rnd(8, hq, t, d), rnd(8, hq, t, d)
        ks, vs = rnd(8, hq, s, d), rnd(8, hq, s, d)

        def per4(fn, *xs):
            n = hq // 4
            return torch.cat([fn(*(x[:, r * n:(r + 1) * n] for x in xs)) for r in range(4)],
                             dim=1)

        def causal(q, k, v):
            return ops.flash_attention(q, k, v, causal=True)

        def cross(q, k, v):
            return ops.flash_attention(q, k, v, causal=False)
        out[f"{name} flash causal self"] = cmp(per4(causal, q, k, v), causal(q, k, v))
        out[f"{name} flash cross"] = cmp(per4(cross, q, ks, vs), cross(q, ks, vs))
        dm = hq * d
        for m in (8 * 2048, 8):
            h, w = rnd(m, dm), rnd(dm, dm, scale=dm ** -0.5)
            cols = [w[:, r * dm // 4:(r + 1) * dm // 4].contiguous() for r in range(4)]
            out[f"{name} column GEMM M={m}"] = cmp(torch.cat([h @ c for c in cols], dim=1), h @ w)
            parts = [torch.mm(h[:, r * dm // 4:(r + 1) * dm // 4],
                              w[r * dm // 4:(r + 1) * dm // 4].contiguous(),
                              out_dtype=torch.float32) for r in range(4)]
            summed = (parts[0] + parts[1] + parts[2] + parts[3]).to(torch.bfloat16)
            exact = (h.double() @ w.double()).to(torch.bfloat16)
            out[f"{name} row_parallel M={m}"] = cmp(summed, h @ w)
            out[f"{name} one-rank GEMM vs float64 M={m}"] = cmp(h @ w, exact)
            out[f"{name} row_parallel vs float64 M={m}"] = cmp(summed, exact)
    for key, val in out.items():
        print(key, json.dumps(val), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

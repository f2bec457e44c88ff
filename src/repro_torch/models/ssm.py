"""Recurrent mixers: Mamba2 (SSD, ngroups = 1) and RWKV-6 ("Finch").

The port of ``repro/models/ssm.py``, with the JAX package's quirks kept:

- Mamba's conv state is float32 (``mamba_state_init``), so with a cache
  (every serving call) the conv's concatenation promotes a bf16 model's
  conv, SiLU, ``x``, ``B`` and ``C`` to float32 and only ``y`` is cast
  back; without one (``state=None``) the zero pad is in ``x.dtype`` and
  the conv runs in it.
- ``a = -exp(a_log)``, ``dt = softplus(dt + dt_bias)`` in float32, the
  ``d_skip`` term, the gated ``rms_norm(y * silu(z))`` over the whole inner
  width.
- RWKV's token shift from ``prev``, its five ``mu`` mixes, the decay ``w =
  exp(-exp(w0 + mix4 @ ww))`` in float32, the bonus ``u``, the ``rms_norm``
  over the whole ``d_model``; the channel mix reads ``mu[0]`` only, with
  squared ReLU.
- States: ``s`` and ``ssd`` float32, ``prev`` in the model's dtype.

The recurrences run through ``ops.mamba_scan`` / ``ops.rwkv_scan``: one
hand-written CUDA kernel launch per layer and call on the card
(``kernels/ssm_scan.py``), the per-step loop on the CPU.  Returned states
are new tensors (the token shifts' ``prev`` a copy of the last row, so it
does not hold the layer's input alive).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import normal, rms_norm

_F32 = torch.float32


def _uniform(gen, shape: tuple, lo: float, width: float, dtype, device) -> torch.Tensor:
    """``U(0, 1) * width + lo`` drawn in float32 from ``gen``, then cast
    (on the ``meta`` device, the shape and dtype alone)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.rand(shape, generator=gen, device=device) * width + lo).to(dtype)


# ---------------------------------------------------------------------------
# Mamba2 (SSD recurrence, ngroups=1)
# ---------------------------------------------------------------------------

def mamba_dims(cfg):
    inner = cfg.ssm.expand * cfg.d_model
    nheads = cfg.ssm.n_heads or max(1, inner // 64)
    head = inner // nheads
    return inner, nheads, head


def mamba_init(gen, cfg, dtype, device) -> dict:
    d = cfg.d_model
    ds, dc = cfg.ssm.d_state, cfg.ssm.d_conv
    inner, nh, _ = mamba_dims(cfg)
    proj_out = 2 * inner + 2 * ds + nh
    return {
        "in_proj": normal(gen, (d, proj_out), d ** -0.5, dtype, device),
        "conv_w": normal(gen, (dc, inner + 2 * ds), 0.1, dtype, device),
        "a_log": torch.zeros(nh, dtype=_F32, device=device),
        "dt_bias": torch.zeros(nh, dtype=_F32, device=device),
        "d_skip": torch.ones(nh, dtype=_F32, device=device),
        "norm": torch.ones(inner, dtype=dtype, device=device),
        "out_proj": normal(gen, (inner, d), inner ** -0.5, dtype, device),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x (B,T,C), w (K,C); state (B,K-1,C) for
    decode.  Returns (y, new_state); with a state of another dtype the
    concatenation promotes, as ``jnp.concatenate`` does."""
    kw = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], kw - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(kw))
    new_state = xp[:, -(kw - 1):].clone() if kw > 1 else pad
    return y, new_state


def mamba_apply(params, x, cfg, state=None, impl: str = "auto"):
    """x (B,T,D) -> (y, new_state).

    state: dict(conv (B,K-1,C), ssd (B,H,ds,hd)); None => zeros (training).
    """
    b, t, _ = x.shape
    ds = cfg.ssm.d_state
    inner, nh, head = mamba_dims(cfg)

    proj = x @ params["in_proj"]
    z, xin, bc, dt = torch.split(proj, [inner, inner, 2 * ds, nh], dim=-1)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_state = state["conv"] if state is not None else None
    conv_out, new_conv = _causal_conv(conv_in, params["conv_w"], conv_state)
    conv_out = F.silu(conv_out)
    xin = conv_out[..., :inner]
    b_in = conv_out[..., inner:inner + ds]
    c_in = conv_out[..., inner + ds:]

    a = -torch.exp(params["a_log"])                                   # (H,)
    dt = F.softplus(dt.float() + params["dt_bias"])                   # (B,T,H)
    xh = xin.reshape(b, t, nh, head).float()

    h0 = state["ssd"] if state is not None else \
        torch.zeros((b, nh, ds, head), dtype=_F32, device=x.device)
    ys, h_fin = ops.mamba_scan(xh, dt, b_in.float(), c_in.float(), a, h0, impl=impl)
    y = ys + params["d_skip"][None, None, :, None] * xh
    y = y.reshape(b, t, inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    return out, {"conv": new_conv, "ssd": h_fin}


def mamba_state_init(cfg, batch: int, device, dtype=_F32) -> dict:
    ds, dc = cfg.ssm.d_state, cfg.ssm.d_conv
    inner, nh, head = mamba_dims(cfg)
    return {"conv": torch.zeros((batch, dc - 1, inner + 2 * ds), dtype=dtype, device=device),
            "ssd": torch.zeros((batch, nh, ds, head), dtype=_F32, device=device)}


# ---------------------------------------------------------------------------
# RWKV-6 ("Finch": data-dependent decay)
# ---------------------------------------------------------------------------

def rwkv_dims(cfg):
    hd = cfg.ssm.d_state if cfg.ssm else 64
    return cfg.d_model // hd, hd


def rwkv_init(gen, cfg, dtype, device) -> dict:
    d = cfg.d_model
    nh, hd = rwkv_dims(cfg)
    s = d ** -0.5
    p = {"mu": _uniform(gen, (5, d), 0.45, 0.1, dtype, device)}
    for name, scale in (("wr", s), ("wk", s), ("wv", s), ("wg", s), ("ww", s * 0.1)):
        p[name] = normal(gen, (d, d), scale, dtype, device)
    p["w0"] = torch.full((d,), -5.0, dtype=_F32, device=device)
    p["u"] = normal(gen, (nh, hd), 0.1, _F32, device)
    p["wo"] = normal(gen, (d, d), s, dtype, device)
    p["ln_x"] = torch.ones(d, dtype=dtype, device=device)
    return p


def _shifted(x, prev):
    """x shifted one step back in time, ``prev`` (B,D) (zeros if None) first."""
    pv = prev[:, None] if prev is not None else \
        torch.zeros((x.shape[0], 1, x.shape[2]), dtype=x.dtype, device=x.device)
    return torch.cat([pv, x[:, :-1]], dim=1)


def rwkv_apply(params, x, cfg, state=None, impl: str = "auto"):
    """RWKV-6 time mixing. x (B,T,D) -> (y, new_state).

    state: dict(s (B,H,hd,hd) f32, prev (B,D)); None => zeros.
    """
    b, t, d = x.shape
    nh, hd = rwkv_dims(cfg)
    xshift = _shifted(x, state["prev"] if state is not None else None)

    def mix(i):
        return x + (xshift - x) * params["mu"][i]

    r = (mix(0) @ params["wr"]).reshape(b, t, nh, hd)
    kk = (mix(1) @ params["wk"]).reshape(b, t, nh, hd)
    v = (mix(2) @ params["wv"]).reshape(b, t, nh, hd)
    g = F.silu(mix(3) @ params["wg"])
    w = torch.exp(-torch.exp(params["w0"] + (mix(4) @ params["ww"]).float()))   # (B,T,D)
    w = w.reshape(b, t, nh, hd)

    s0 = state["s"] if state is not None else \
        torch.zeros((b, nh, hd, hd), dtype=_F32, device=x.device)
    ys, s_fin = ops.rwkv_scan(r.float(), kk.float(), v.float(), w, params["u"], s0, impl=impl)
    y = ys.reshape(b, t, d).to(x.dtype)
    y = rms_norm(y, params["ln_x"], cfg.norm_eps) * g
    out = y @ params["wo"]
    return out, {"s": s_fin, "prev": x[:, -1].clone()}


def rwkv_state_init(cfg, batch: int, device, dtype) -> dict:
    """``s`` float32, ``prev`` in ``dtype``, the model's."""
    nh, hd = rwkv_dims(cfg)
    return {"s": torch.zeros((batch, nh, hd, hd), dtype=_F32, device=device),
            "prev": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)}


def rwkv_channel_mix_init(gen, cfg, dtype, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"mu": _uniform(gen, (2, d), 0.45, 0.1, dtype, device),
            "w_in": normal(gen, (d, f), d ** -0.5, dtype, device),
            "w_out": normal(gen, (f, d), f ** -0.5, dtype, device)}


def rwkv_channel_mix(params, x, prev=None):
    """RWKV channel mixing (token-shifted squared-ReLU MLP); returns (y,
    the last row of x)."""
    xk = x + (_shifted(x, prev) - x) * params["mu"][0]
    h = torch.square(F.relu(xk @ params["w_in"]))
    return h @ params["w_out"], x[:, -1].clone()

"""Carry container state between the JAX package and the port.

The JAX containers' states are dicts or NamedTuples of u32/i32 arrays;
with ``np.asarray`` applied to each field, the ``*_from_numpy`` helpers
turn them into the port's states (int32 bit-views on ``device``), and
the ``*_to_numpy`` helpers go back to numpy arrays of the JAX dtypes
(u32 words, i32 cursors).  This is the system's "weights carried
across": both packages can start from the same populated containers.

  hash map  ``repro.containers.hashmap.export_state`` -> {tkeys, tvals, status}
  queue     ``repro.containers.queue.export_state``   -> {data, head, tail,
                                                          tail_ready, head_ready}
  Bloom     ``BloomState._asdict()``                  -> {words}

And the LM's parameters: ``lm_params_from_numpy`` takes the JAX
package's ``lm.init_params`` pytree (``np.asarray`` on each leaf) and
unstacks its scanned units into the port's per-layer list (an MoE
layer's ``moe`` tree too: the float32 router, the bf16 expert stacks; an
MLA layer's six ``attn`` leaves; the MTP head's ``mtp_block``,
``mtp_norm`` and ``mtp_proj``; a Mamba2 or RWKV-6 layer's leaves, the
float32 ``a_log``, ``dt_bias``, ``d_skip``, ``w0`` and ``u`` beside the
model-dtype ones; an ``a`` layer's 0-d ``use_shared`` marker, stacked to
one value per unit in JAX; Zamba's ``shared_attn``; an encoder-decoder's
``enc_stack``, unstacked into the port's ``encoder`` list, its
``enc_norm``, and each decoder layer's ``ln_x`` and ``xattn``);
``lm_params_to_numpy`` goes back (bf16 leaves come back as float32 arrays
of the same values: numpy has no bfloat16 of its own).
``opt_state_from_numpy`` / ``opt_state_to_numpy`` carry the JAX package's
AdamW state (``{"step", "per_param"}``, ``per_param`` shaped like the
parameter pytree with a dict of moments at each leaf) the same way, so a
train step starts from the same parameters and moments in both packages.
``lm_params_for_rank`` gives one rank of a ``(data, model)`` layout its
slice of the LM's parameters (``models/sharding.shard_params``: an MoE
layer's experts ``[r*E/P, (r+1)*E/P)``, as the JAX package's ``shard_map``
shards them, and the heads', hidden width's and vocab's slices, as its
``param_spec`` places them, Zamba's shared block and the encoder's blocks
included; Mamba2's and RWKV-6's leaves by whole heads, where JAX's rule
cuts through them).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.containers.bloom import BloomState
from repro_torch.containers.hashmap import HashMapState
from repro_torch.containers.queue import QueueState
from repro_torch.models.sharding import shard_params

_MAP = ("tkeys", "tvals", "status")
_QUEUE = ("data", "head", "tail", "tail_ready", "head_ready")


def _words(a, device) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.array(a, dtype=np.uint32 if a.dtype == np.uint32
                                     else np.int32).view(np.int32)).to(device)


def hashmap_state_from_numpy(exported: dict, device="cuda") -> HashMapState:
    """u32 numpy arrays ``{tkeys, tvals, status}`` -> port state on ``device``."""
    return HashMapState(*(_words(exported[k], device) for k in _MAP))


def hashmap_state_to_numpy(state: HashMapState) -> dict:
    """Port state -> ``{tkeys, tvals, status}`` u32 numpy arrays."""
    return {k: getattr(state, k).cpu().numpy().view(np.uint32) for k in _MAP}


def queue_state_from_numpy(exported: dict, device="cuda") -> QueueState:
    """``{data (u32), head, tail, tail_ready, head_ready (i32)}`` -> port state."""
    return QueueState(*(_words(exported[k], device) for k in _QUEUE))


def queue_state_to_numpy(state: QueueState) -> dict:
    """Port state -> ``{data}`` u32 and the four i32 cursors as numpy."""
    out = {k: getattr(state, k).cpu().numpy() for k in _QUEUE}
    out["data"] = out["data"].view(np.uint32)
    return out


def bloom_state_from_numpy(exported: dict, device="cuda") -> BloomState:
    """``{words}`` (nb, 2) u32 -> port state on ``device``."""
    return BloomState(_words(exported["words"], device))


def bloom_state_to_numpy(state: BloomState) -> dict:
    """Port state -> ``{words}`` (nb, 2) u32 numpy."""
    return {"words": state.words.cpu().numpy().view(np.uint32)}


# --------------------------------------------------------------------------
# LM parameters
# --------------------------------------------------------------------------

def _layout(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_prefix, n_units, n_rem) of the JAX package's layer stack."""
    prefix = cfg.moe.first_k_dense if cfg.moe else 0
    u = len(cfg.layer_pattern)
    rest = cfg.n_layers - prefix
    return prefix, rest // u, rest % u


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_from_numpy(tree: dict, device="cuda") -> dict:
    """A nested dict of numpy arrays (one layer's or module's JAX
    parameters, e.g. ``moe_init``'s) -> the same dict of tensors on
    ``device``, dtypes kept (bf16 included)."""
    return _tree(lambda a: _tensor(a, device), tree)


#: the LM's parameters outside the layer stack
_TOP = ("embed", "final_norm", "lm_head", "shared_attn", "enc_norm", "mtp_block", "mtp_norm",
        "mtp_proj")


def _unstack(tree: dict, n: int, device) -> list[dict]:
    """A tree of arrays stacked on a leading axis of ``n`` -> ``n`` trees
    of tensors on ``device``."""
    return [_tree(lambda a: _tensor(np.asarray(a)[u], device), tree) for u in range(n)]


def _stack(blocks: list):
    """The trees of arrays in ``blocks`` -> one tree stacked on a leading axis."""
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def lm_params_from_numpy(params_np: dict, cfg: ArchConfig, device="cuda") -> dict:
    """The JAX LM pytree -> the port's parameters on ``device``: the layers
    in order (``prefix_i``, then each unit's ``p0..p{u-1}`` from
    ``stack``, then ``rem_i``), and the encoder's blocks from ``enc_stack``."""
    prefix, n_units, n_rem = _layout(cfg)
    pat = len(cfg.layer_pattern)
    layers = [tree_from_numpy(params_np[f"prefix_{i}"], device) for i in range(prefix)]
    if n_units:
        units = [_unstack(params_np["stack"][f"p{i}"], n_units, device) for i in range(pat)]
        layers += [units[i][u] for u in range(n_units) for i in range(pat)]
    layers += [tree_from_numpy(params_np[f"rem_{i}"], device) for i in range(n_rem)]
    out = {k: tree_from_numpy(params_np[k], device) for k in _TOP if k in params_np}
    out["layers"] = layers
    if "enc_stack" in params_np:
        out["encoder"] = _unstack(params_np["enc_stack"], cfg.encoder_layers, device)
    return out


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_to_numpy(params: dict, cfg: ArchConfig) -> dict:
    """The port's parameters -> the JAX LM pytree layout of numpy arrays."""
    prefix, n_units, n_rem = _layout(cfg)
    pat = len(cfg.layer_pattern)
    layers = [_tree(_array, bp) for bp in params["layers"]]
    out = {k: _tree(_array, params[k]) for k in _TOP if k in params}
    for i in range(prefix):
        out[f"prefix_{i}"] = layers[i]
    if n_units:
        units = [[layers[prefix + u * pat + i] for u in range(n_units)] for i in range(pat)]
        out["stack"] = {f"p{i}": _stack(units[i]) for i in range(pat)}
    for i in range(n_rem):
        out[f"rem_{i}"] = layers[prefix + n_units * pat + i]
    if "encoder" in params:
        out["enc_stack"] = _stack([_tree(_array, bp) for bp in params["encoder"]])
    return out


def opt_state_from_numpy(state_np: dict, cfg: ArchConfig, device="cuda") -> dict:
    """The JAX AdamW state of the LM (``np.asarray`` on each leaf) -> the
    port's (``optim.adamw_init``'s layout) on ``device``: the moments
    unstacked like the parameters, bf16 moments kept in bf16."""
    return {"step": torch.tensor(int(np.asarray(state_np["step"])), dtype=torch.int32,
                                 device=device),
            "per_param": lm_params_from_numpy(state_np["per_param"], cfg, device)}


def opt_state_to_numpy(state: dict, cfg: ArchConfig) -> dict:
    """The port's AdamW state -> the JAX layout of numpy arrays (bf16
    moments as float32 arrays of the same values)."""
    return {"step": np.asarray(int(state["step"]), np.int32),
            "per_param": lm_params_to_numpy(state["per_param"], cfg)}


def lm_params_for_rank(params_np: dict, cfg: ArchConfig, layout, device="cuda") -> dict:
    """The JAX LM pytree -> this rank's parameters (``layout``, a
    ``models/sharding.Layout``) on ``device``."""
    return shard_params(lm_params_from_numpy(params_np, cfg, device), cfg, layout)

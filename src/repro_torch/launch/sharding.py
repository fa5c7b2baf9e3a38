"""Sharding rules: parameter, optimizer, cache and input specs per
(architecture, mode, mesh) — port of ``repro.launch.sharding``.

A spec is a tuple with one entry per dim of a tensor: ``None``
(replicated), an axis name, or a tuple of axis names (split over their
product, row-major) — the port's stand-in for ``PartitionSpec``.  The rules
are the reference's:
  * embeddings vocab-sharded over 'model' when divisible, else d_model-sharded
  * attention / ssm / rwkv projections column-sharded on the output feature
    dim, out-projections row-sharded
  * MoE expert tensors sharded on the expert dim
  * FSDP archs (llama4-scout, yi-34b) additionally shard big matrices over
    'data' on the non-TP dim
  * train activations: batch over ('pod', 'data'); decode KV caches: batch
    over ('pod', 'data') and cache-seq over 'model'; batch-1 long-context
    shards cache-seq over every axis
  * optimizer moments follow the parameters, plus 'data' on the largest
    replicated dim (ZeRO-1).

They apply to the port's parameter names, which are the reference's pytree
paths with each layer stack cut into ``<stack>.<i>.``
(``models/convert.py``): the rule reads the name without the index, and a
per-layer leaf has no leading layer dim, so its spec is the reference's
without that dim's entry (the reference never shards it).  The
arithmetic the dry run needs is here too: ``shard_shape`` and
``device_bytes``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from repro_torch.launch.mesh import data_axes

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def param_path(name: str) -> Tuple[str, ...]:
    """The reference's pytree path of a port parameter name: the layer
    index dropped (``layers.3.attn.wq.w`` -> ``("layers", "attn", "wq",
    "w")``)."""
    return tuple(s for s in name.split(".") if not s.isdigit())


def param_spec(path: Tuple[str, ...], shape, cfg, mesh, *, mode: str) -> Spec:
    """The spec of one parameter leaf of ``shape`` at ``path`` (a per-layer
    leaf: no layer dim)."""
    tp = _axis_size(mesh, "model")
    fsdp = cfg.fsdp and (mode == "train" or cfg.fsdp_inference)
    name = path[-1] if path else ""
    parent = path[-2] if len(path) > 1 else ""
    ndim = len(shape)

    def spec(*dims) -> Spec:
        out = dims + (None,) * (ndim - len(dims))
        return tuple(out[:ndim])

    # ---- embeddings / head ----
    if path and path[0] == "embed":
        return ("model", None) if _div(cfg.vocab_size, tp) else (None, "model")
    if path and path[0] == "lm_head":
        return (None, "model") if _div(cfg.vocab_size, tp) else ("model", None)
    if path and path[0] == "dec_pos":
        return (None, None)

    # ---- norms / scalars / small vectors: replicated ----
    if ndim <= 1 or name in ("b", "A_log", "D", "dt_bias", "u", "w_base",
                             "mu_x", "mu_k", "mu_r", "conv_b", "conv_bc_b"):
        return spec()
    if name == "mu_base" or parent in ("lora_mu", "lora_w") or name == "router":
        return spec()
    if parent in ("B_proj", "C_proj"):
        return spec()
    if name in ("conv_w", "conv_bc_w"):
        return spec(None, "model") if name == "conv_w" else spec()

    # ---- MoE experts: (E, d, ff) / (E, ff, d) ----
    if cfg.is_moe and ndim >= 3 and "moe" in path and name in ("wg", "wu", "wd"):
        return spec("model", "data", None) if fsdp else spec("model", None, None)

    d0, d1 = shape[-2], shape[-1]
    # ---- generic 2-D matmul weights ----
    if ndim == 2:
        row_like = name in ("wo", "wd", "out_proj") or parent == "out_proj" \
            or name == "w" and parent in ("wo", "wd", "out_proj")
        if row_like:
            base = ("model", "data") if fsdp else ("model", None)
            return spec(*base) if _div(d0, tp) else spec()
        if _div(d1, tp):
            return spec("data", "model") if fsdp and _div(
                d0, _axis_size(mesh, "data")) else spec(None, "model")
        if _div(d0, tp):
            return spec("model", None)
        return spec()

    # ---- inv_proj (n_inv, 2d, d) and other 3-D ----
    if _div(d1, tp):
        return (None,) * (ndim - 2) + (None, "model")
    return (None,) * ndim


def params_shardings(params, cfg, mesh, *, mode: str) -> Dict[str, Spec]:
    """{parameter name: spec} of a ``Model`` or a {name: tensor} map."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) \
        else params.items()
    return {n: param_spec(param_path(n), tuple(t.shape), cfg, mesh, mode=mode)
            for n, t in items}


# ---------------------------------------------------------------------------
# Optimizer state: params' specs + ZeRO-1 'data' sharding where free
# ---------------------------------------------------------------------------

def _flat_axes(spec) -> list:
    out = []
    for s in spec:
        if s is None:
            continue
        out.extend(s if isinstance(s, tuple) else (s,))
    return out


def opt_state_shardings(opt_state: Mapping, p_specs: Mapping[str, Spec],
                        cfg, mesh) -> dict:
    """Specs of ``{"m", "v", "step"}``: each moment its parameter's spec,
    plus 'data' on its largest unsharded dim that 'data' divides."""
    def visit(ps: Spec, t: torch.Tensor) -> Spec:
        if t.ndim == 0:
            return ()
        spec = list(ps) + [None] * (t.ndim - len(ps))
        if "data" not in _flat_axes(spec) and "data" in mesh.axis_names:
            dsz = mesh.shape["data"]
            best, best_dim = None, -1
            for i, (s, dim) in enumerate(zip(spec, t.shape)):
                if s is None and dim % dsz == 0 and dim > best_dim:
                    best, best_dim = i, dim
            if best is not None and best_dim >= dsz:
                spec[best] = "data"
        return tuple(spec)

    return {"m": {n: visit(p_specs[n], t) for n, t in opt_state["m"].items()},
            "v": {n: visit(p_specs[n], t) for n, t in opt_state["v"].items()},
            "step": ()}


# ---------------------------------------------------------------------------
# Caches & inputs
# ---------------------------------------------------------------------------

def cache_spec(path: Tuple[str, ...], shape, cfg, mesh, batch: int) -> Spec:
    """KV caches (L, B, S, H, hd); ssm states (L, B, ...); rwkv states."""
    da = data_axes(mesh)
    bsz = int(np.prod([mesh.shape[a] for a in da])) if da else 1
    tp = _axis_size(mesh, "model")
    name = path[-1] if path else ""
    batch_ok = _div(batch, bsz)
    ndim = len(shape)

    if name in ("k", "v", "xk", "xv"):
        seq, heads = shape[2], shape[3]
        if _div(seq, tp):
            sdim, hdim = "model", None
        elif _div(heads, tp):
            sdim, hdim = None, "model"
        else:
            sdim = hdim = None
        if batch_ok:
            return (None, da, sdim, hdim, None)
        return (None, None, da + (("model",) if sdim else ()), hdim, None)
    if name in ("ssm", "wkv"):
        return (None, da if batch_ok else None, "model", None, None)
    if name in ("conv_x", "conv_bc", "tm_shift", "cm_shift"):
        spec = [None, da if batch_ok else None] + [None] * (ndim - 2)
        if name == "conv_x" and ndim >= 4:
            spec[-1] = "model"
        return tuple(spec)
    return (None,) * ndim


def cache_shardings(caches: Mapping, cfg, mesh, batch: int,
                    path: Tuple[str, ...] = ()) -> dict:
    """The specs of a (nested) cache dict, same structure."""
    return {k: cache_shardings(v, cfg, mesh, batch, path + (k,))
            if isinstance(v, Mapping)
            else cache_spec(path + (k,), tuple(v.shape), cfg, mesh, batch)
            for k, v in caches.items()}


def batch_shardings(batch_shape: Mapping, mesh, batch: int) -> dict:
    """Input batch: leading batch dim over data axes (replicated if the
    batch does not divide); M-RoPE positions (3, B, S) on dim 1."""
    da = data_axes(mesh)
    bsz = int(np.prod([mesh.shape[a] for a in da])) if da else 1

    def visit(t) -> Spec:
        shape = tuple(t.shape)
        nd = len(shape)
        if nd == 0 or not _div(batch, bsz) or shape[0] != batch:
            if nd >= 2 and shape[0] == 3 and shape[1] == batch \
                    and _div(batch, bsz):
                return (None, da) + (None,) * (nd - 2)
            return (None,) * nd
        return (da,) + (None,) * (nd - 1)

    return {k: visit(v) for k, v in batch_shape.items()}


# ---------------------------------------------------------------------------
# Per-device arithmetic
# ---------------------------------------------------------------------------

def _entry_size(entry: Entry, mesh) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    return int(np.prod([_axis_size(mesh, a) for a in axes]))


def shard_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's shard of a tensor of ``shape`` laid out by ``spec``;
    raises where an entry's axes do not divide their dim (the reference's
    jit rejects such an argument)."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = []
    for i, dim in enumerate(shape):
        k = _entry_size(spec[i], mesh) if i < len(spec) else 1
        if dim % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide over "
                             f"{k} ({spec[i]})")
        out.append(dim // k)
    return tuple(out)


def device_bytes(tensors, specs, mesh) -> int:
    """The bytes of the largest device's shards of a (nested) dict of
    tensors under the same-structured dict of specs.  Every shard of a leaf
    has one shape (``shard_shape``), so each device holds the same bytes and
    the largest is any device's."""
    if isinstance(tensors, Mapping):
        return sum(device_bytes(tensors[k], specs[k], mesh) for k in tensors)
    n = int(np.prod(shard_shape(tuple(tensors.shape), specs, mesh)))
    return n * tensors.element_size()

"""Dry run: what every (architecture x input shape x mesh) cell costs per
device on the production mesh — port of ``repro.launch.dryrun``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --anns [--gather shardwise]

The port accounts what the reference's dry run accounts, not how: there
is no XLA and no HLO.  Everything runs on ``meta`` tensors (shapes and
dtypes, no storage), on the host, in seconds, with or without a card.
Per cell:
  * memory — the per-device argument bytes, exact from the sharding rules
    (``launch/sharding.py``): params, optimizer state and batch (train);
    params and batch (prefill); params, caches and token (decode), the
    largest device's.  ``temp_bytes`` is the peak of live ``meta`` bytes
    of one data shard's step, arguments excluded, measured at L1/L2 and
    extrapolated like the rest: an upper bound, since the port's forward
    has no tensor parallelism (a data shard's dense layers and all its
    model shards' experts are counted on one device).
  * flops and bytes accessed per device — one data shard's step on
    ``meta`` at depths L1/L2 (one and two layer periods; the MoE over the
    shard's row of model shards, ``RowMesh``), under ``FlopCounterMode``
    and a dispatch mode that sums each op's operand and result bytes (what
    XLA's "bytes accessed" counts), divided by the model shards and
    extrapolated linearly to full depth, as the reference does.  The attention kernel
    (K8) takes no meta tensors: a stand-in counts its two products and its
    q, k, v, o bytes.
  * collective bytes — the explicit collectives only
    (``"coll_scope": "explicit"``): the sharded MoE's and the pod search
    step's hooks', from the collective ledger (``core/collectives.py``).
    The reference's HLO also holds the tensor-parallel collectives GSPMD
    inserts in its dense layers; the port's one-controller forward has no
    counterpart to them (ROADMAP).
Not ported: the ``XLA_FLAGS`` prelude, HLO text parsing (the ledger
replaces it), ``compile_s``, ``code_bytes`` and the full rolled
compilation's analysis (``full_rolled``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from contextlib import ExitStack
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_runnable, get_config
from repro_torch.core import collectives
from repro_torch.core.distributed import PodMesh
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import data_axes, make_production_mesh, n_devices
from repro_torch.models import moe_sharded
from repro_torch.models import steps as ST

# ---------------------------------------------------------------------------
# Roofline terms: the H100's
# ---------------------------------------------------------------------------

HW = {  # NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit (data sheet)
    "peak_flops": 989e12,     # bf16 dense on the tensor cores / card
    "hbm_bw": 3.35e12,        # B/s HBM3 / card
    "ici_bw": 450e9,          # B/s NVLink 4, one direction / card
    "hbm_bytes": 80 * 2**30,  # device memory / card
}
HW_LABEL = ("NVIDIA H100 80GB HBM3 (SXM5), 700 W: bf16 dense 989 TFLOP/s, "
            "HBM3 3.35 TB/s, NVLink 4 450 GB/s a direction, 80 GiB")


def card_bytes() -> int:
    """The card's memory where one is present, else the H100's 80 GiB."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return HW["hbm_bytes"]


def roofline_terms(acct: Dict[str, float]) -> Dict[str, float]:
    t_c = acct["flops_per_dev"] / HW["peak_flops"]
    t_m = acct["bytes_per_dev"] / HW["hbm_bw"]
    t_x = acct["coll_bytes_per_dev"] / HW["ici_bw"]
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))
    return {"t_compute": t_c, "t_memory": t_m, "t_collective": t_x,
            "bottleneck": dom[1],
            "roofline_frac": t_c / max(t_c, t_m, t_x, 1e-30)}


# ---------------------------------------------------------------------------
# Counting modes on meta tensors
# ---------------------------------------------------------------------------

def _tensors(x):
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


class ByteCounter(TorchDispatchMode):
    """Sums every op's tensor operand and result bytes (views move no data
    and are skipped)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(collectives.tensor_bytes(t)
                              for t in _tensors((args, kwargs, out)))
        return out


class PeakLive(TorchDispatchMode):
    """The peak bytes of storages created inside the block and alive at
    once.  A storage is dead when only this tracker refers to it; the dead
    are swept out whenever the live bytes would pass the peak, so the peak
    is exact.  ``exclude``: tensors that exist before the block (arguments
    an op may return or write in place), whose storages are never
    counted."""

    def __init__(self, exclude=()):
        super().__init__()
        self.live: Dict[int, Any] = {}
        self.held = {t.untyped_storage()._cdata for t in _tensors(exclude)}
        self.cur = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata not in self.live and st._cdata not in self.held:
                self.live[st._cdata] = st
                self.cur += st.nbytes()
        if self.cur > self.peak:
            for key in [k for k in self.live
                        if torch._C._storage_Use_Count(k) <= 1]:
                self.cur -= self.live.pop(key).nbytes()
            self.peak = max(self.peak, self.cur)
        return out


def _attention_counter(acc: Dict[str, float]):
    """The K8 stand-in's accounting: q·kᵀ and P·V (2 flops a product
    term; causal keeps (Sk + 1) / 2 keys a row on average), q, k, v read
    and o written once."""
    def on_call(q, k, v, causal):
        B, Sq, H, D = q.shape
        Sk = k.shape[1]
        keys = (Sk + 1) / 2 if causal else Sk
        acc["flops"] += 4.0 * B * H * Sq * keys * D
        acc["bytes"] += 2 * collectives.tensor_bytes(q) + \
            collectives.tensor_bytes(k) + collectives.tensor_bytes(v)
    return on_call


# ---------------------------------------------------------------------------
# Cell construction: the step and its meta inputs
# ---------------------------------------------------------------------------

def _cfg_at(cfg, n_layers: Optional[int]):
    if n_layers is None:
        return cfg
    enc = dict(n_encoder_layers=n_layers) if cfg.n_encoder_layers else {}
    return dataclasses.replace(cfg, n_layers=n_layers, **enc)


def build_cell(cfg, shape, batch: int):
    """(step, args, the arguments as {"params", "opt" | "caches", "batch" |
    "token"} dicts of tensors) of the cell's step on ``meta`` at ``batch``
    rows."""
    shape = dataclasses.replace(shape, global_batch=batch)
    model = SP.params_specs(cfg)
    named = {"params": dict(model.named_parameters())}
    if shape.mode == "train":
        model.requires_grad_(True)
        named["opt"] = SP.opt_specs(cfg, model)
        named["batch"] = SP.batch_specs(cfg, shape)
        return (ST.make_train_step(cfg, microbatches=1),
                (model, named["opt"], named["batch"]), named)
    if shape.mode == "prefill":
        named["batch"] = SP.batch_specs(cfg, shape)
        return ST.make_prefill_step(cfg), (model, named["batch"]), named
    named["caches"] = SP.cache_specs(cfg, shape, model)
    named["token"] = SP.decode_input_specs(cfg, shape)["token"]
    return (ST.make_decode_step(cfg),
            (model, named["caches"], named["token"], shape.seq_len - 1),
            named)


def arg_bytes(cfg, shape, mesh) -> int:
    """Per-device bytes of the cell's arguments under the sharding rules."""
    _, _, args = build_cell(cfg, shape, shape.global_batch)
    B = shape.global_batch
    pspec = SH.params_shardings(args["params"], cfg, mesh, mode=shape.mode)
    total = SH.device_bytes(args["params"], pspec, mesh)
    if "opt" in args:
        ospec = SH.opt_state_shardings(args["opt"], pspec, cfg, mesh)
        total += SH.device_bytes(args["opt"], ospec, mesh)
    if "batch" in args:
        total += SH.device_bytes(args["batch"], SH.batch_shardings(
            args["batch"], mesh, B), mesh)
    if "caches" in args:
        total += SH.device_bytes(args["caches"], SH.cache_shardings(
            args["caches"], cfg, mesh, B), mesh)
        tok = {"token": args["token"]}
        total += SH.device_bytes(tok, SH.batch_shardings(tok, mesh, B), mesh)
    return total


class RowMesh(PodMesh):
    """Data shard 0's row of a mesh: every data axis cut to its first
    device, the model axis whole; ``shape`` stays the mesh's, so the FSDP
    weights are gathered over the mesh's ``"data"`` width."""

    def __init__(self, mesh: PodMesh):
        da = data_axes(mesh)
        idx = tuple(slice(0, 1) if a in da else slice(None)
                    for a in mesh.axis_names)
        super().__init__(mesh.devices[idx], mesh.axis_names)
        self._shape = mesh.shape

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._shape)


def account(cfg, shape, mesh, n_layers: int) -> Dict[str, Any]:
    """One data shard's step at ``n_layers`` on ``meta`` (its batch rows;
    the MoE over the shard's row of model shards): flops, bytes accessed
    and explicit collective bytes per device, and the peak of its live
    bytes with the bytes of its outputs.  The data shards do the same work
    (a batch the data axes do not divide is whole on each), so a device's
    share is the shard's over the model axis."""
    cfg = _cfg_at(cfg, n_layers)
    n_data = int(np.prod([mesh.shape[a] for a in data_axes(mesh)]))
    B = shape.global_batch
    step, args, named = build_cell(cfg, shape,
                                   B // n_data if B % n_data == 0 else B)
    att = {"flops": 0.0, "bytes": 0}
    bc, pk = ByteCounter(), PeakLive(exclude=named)
    fc = FlopCounterMode(display=False)
    moe_sharded.set_moe_mesh(RowMesh(mesh) if cfg.is_moe else None,
                             data_axes(mesh))
    try:
        with ExitStack() as es:
            es.enter_context(SP.meta_attention(_attention_counter(att)))
            led = es.enter_context(collectives.counting())
            for mode in (fc, bc, pk):
                es.enter_context(mode)
            out = step(*args)
    finally:
        moe_sharded.set_moe_mesh(None, ())
    tp = mesh.shape["model"]
    return {"flops_per_dev": (fc.get_total_flops() + att["flops"]) / tp,
            "bytes_per_dev": (bc.bytes + att["bytes"]) / tp,
            "coll_bytes_per_dev": int(led.get("total", 0)),
            "coll_breakdown": {k: v for k, v in led.items() if k != "total"},
            "temp_bytes": int(pk.peak),
            "output_bytes": sum(collectives.tensor_bytes(t)
                                for t in _tensors(out)
                                if t.untyped_storage()._cdata not in pk.held)}


def _layer_period(cfg) -> int:
    return cfg.shared_attn_period if cfg.family == "hybrid" else 1


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             accounting: bool = True, verbose: bool = True) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = n_devices(mesh)
    t0 = time.perf_counter()
    p = _layer_period(cfg)
    L1, L2 = p, 2 * p
    acct = {L: account(cfg, shape, mesh, L) for L in (L1, L2)}
    extrap = {}
    for key in ("flops_per_dev", "bytes_per_dev", "coll_bytes_per_dev",
                "temp_bytes"):
        per_layer = (acct[L2][key] - acct[L1][key]) / (L2 - L1)
        extrap[key] = acct[L1][key] + per_layer * (cfg.n_layers - L1)
    memory = {"temp_bytes": int(extrap.pop("temp_bytes")),
              "arg_bytes": arg_bytes(cfg, shape, mesh),
              "output_bytes": acct[L1]["output_bytes"]}
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
        "memory": memory, "temp_is_upper_bound": True,
        "coll_scope": "explicit", "hw": HW_LABEL,
        "fits": memory["arg_bytes"] + memory["temp_bytes"] <= card_bytes(),
        "card_bytes": card_bytes()}
    if accounting:
        result["accounting"] = {"L1": acct[L1], "L2": acct[L2],
                                "extrapolated": extrap}
        result["roofline"] = roofline_terms(extrap)
        result["global_flops"] = extrap["flops_per_dev"] * n_dev
    result["dryrun_s"] = time.perf_counter() - t0

    if verbose:
        mem_gb = memory["temp_bytes"] / 2**30
        arg_gb = memory["arg_bytes"] / 2**30
        line = (f"[dryrun] {arch:24s} {shape_name:12s} mesh={result['mesh']:8s} "
                f"temp<={mem_gb:7.2f}GiB args={arg_gb:7.2f}GiB "
                f"fits={result['fits']}")
        if "roofline" in result:
            r = result["roofline"]
            line += (f" Tc={r['t_compute']*1e3:8.2f}ms Tm={r['t_memory']*1e3:8.2f}ms "
                     f"Tx={r['t_collective']*1e3:8.2f}ms -> {r['bottleneck']}")
        print(line, flush=True)
    return result


# ---------------------------------------------------------------------------
# The pod search step
# ---------------------------------------------------------------------------

DATASETS = {"deep": (96, 48), "t2i": (200, 128), "wiki": (768, 256),
            "laion": (768, 160)}


def _placement_spec(pl, t) -> tuple:
    return ((pl.axes,) if pl.axes else (None,)) + (None,) * (t.ndim - 1)


def run_anns(*, multi_pod: bool = False, gather: str = "naive",
             dataset: str = "deep", verbose: bool = True) -> Dict[str, Any]:
    """The distributed PilotANN search step's per-device cost (DESIGN.md
    §2 mapping).  Memory from ``pod_array_specs`` / ``pod_shardings``; the
    stage-②③ hooks' flops, bytes and collectives from stage ② and one
    stage-③ round (neighbour rows, then the W·R candidates' distances),
    counted once (the reference's loop-body-counted-once rule) over the
    whole query batch: every corpus shard scores the batch's ids it owns
    and the owners' values are selected (``owner_select``, an all-reduce),
    so a device computes one of the K parts: the hooks run over one
    corpus shard's tables.  Stages 0 and ① run on
    replicated tables and cross no shard; their kernels (K1-K5) take no
    meta tensors and are not counted."""
    from repro_torch.core import traversal as T
    from repro_torch.core.multistage import SearchParams
    from repro_torch.core.distributed import (
        PodIndexSpec, _gather_rows, make_shardwise_fns, place_arrays,
        pod_array_specs, pod_shardings, shard_local_nbr_fn)
    if gather not in ("naive", "shardwise"):
        raise ValueError(f"unknown gather mode {gather!r}")
    d, dp = DATASETS[dataset]
    spec = PodIndexSpec(d=d, d_primary=dp)
    mesh = make_production_mesh(multi_pod=multi_pod)
    arrays = pod_array_specs(spec, mesh)
    shards = pod_shardings(spec, mesh)
    args = sum(SH.device_bytes(arrays[k], _placement_spec(shards[k], v), mesh)
               for k, v in arrays.items())
    placed = place_arrays(arrays, shards, mesh)
    corpus = shards["full_vecs"].axes
    K = len(placed["full_vecs"])
    Np = arrays["full_vecs"].shape[0]
    rows_per = Np // K
    B, E1, W = spec.query_batch, spec.ef_pilot, spec.frontier_width
    q = arrays["queries"]
    nq = len(mesh.axis_devices(shards["queries"].axes))

    def hooks(nbrs, vecs, rp):
        if gather == "shardwise":
            nbr_for, dist_for = make_shardwise_fns(mesh, corpus, None,
                                                   rp * len(vecs), spec.R)
            return nbr_for(nbrs), dist_for(vecs)
        # naive: the owners' rows are gathered, then scored
        return (shard_local_nbr_fn(nbrs, rp),
                lambda q, ids, fresh=None: T.sq_dists(
                    q, _gather_rows(vecs, ids, rp)))

    def one_round(nbr_fn, dist_fn):
        ids = torch.empty((B, E1), dtype=torch.int32, device="meta")
        dist_fn(q, ids)                                   # stage ②
        u = torch.empty((B * W,), dtype=torch.int32, device="meta")
        rows = nbr_fn(u)                                  # stage ③ round
        return dist_fn(q, rows.reshape(B, W * spec.R))

    t0 = time.perf_counter()
    # one device's part: the hooks over its own corpus shard (the first),
    # whose owner_select records the all-reduce every device takes part in
    bc, fc = ByteCounter(), FlopCounterMode(display=False)
    pk = PeakLive(exclude=placed)
    with collectives.counting() as led, fc, bc, pk:
        one_round(*hooks(placed["full_neighbors"][:1],
                         placed["full_vecs"][:1], rows_per))
    acct = {"flops_per_dev": fc.get_total_flops(),
            "bytes_per_dev": bc.bytes,
            "coll_bytes_per_dev": int(led.get("total", 0)),
            "coll_breakdown": {k: v for k, v in led.items() if k != "total"},
            "temp_bytes": int(pk.peak), "arg_bytes": int(args),
            # (ids, dists) of each device's query rows, int32 and fp32
            "output_bytes": B // nq * SearchParams().k * 8}
    res = {"arch": f"pilotann-{dataset}", "shape": f"search-{gather}",
           "mesh": _mesh_name(multi_pod),
           "memory": {k: acct[k] for k in ("temp_bytes", "arg_bytes",
                                           "output_bytes")},
           "accounting": {"extrapolated": acct},
           "roofline": roofline_terms(acct), "coll_scope": "explicit",
           "hw": HW_LABEL, "fits": args + acct["temp_bytes"] <= card_bytes(),
           "card_bytes": card_bytes(),
           "dryrun_s": time.perf_counter() - t0}
    if verbose:
        r = res["roofline"]
        print(f"[dryrun] {res['arch']:24s} {res['shape']:12s} mesh={res['mesh']:8s} "
              f"temp={acct['temp_bytes']/2**30:7.2f}GiB "
              f"args={acct['arg_bytes']/2**30:7.2f}GiB fits={res['fits']} "
              f"Tc={r['t_compute']*1e3:8.2f}ms Tm={r['t_memory']*1e3:8.2f}ms "
              f"Tx={r['t_collective']*1e3:8.2f}ms -> {r['bottleneck']}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--anns", action="store_true")
    ap.add_argument("--gather", default="naive")
    ap.add_argument("--dataset", default="deep")
    ap.add_argument("--no-accounting", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    results = []
    if args.anns:
        results.append(run_anns(multi_pod=args.multi_pod, gather=args.gather,
                                dataset=args.dataset))
    elif args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                try:
                    results.append(run_cell(arch, shape, multi_pod=args.multi_pod,
                                            accounting=not args.no_accounting))
                except Exception as e:  # noqa: BLE001 — report, keep going
                    print(f"[dryrun] {arch} {shape} FAILED: {type(e).__name__}: {e}",
                          flush=True)
                    results.append({"arch": arch, "shape": shape,
                                    "error": f"{type(e).__name__}: {e}"})
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required (or --all / --anns)")
        results.append(run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                                accounting=not args.no_accounting))

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, default=str)
    failed = [r for r in results if "error" in r]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

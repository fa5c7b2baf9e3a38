"""Plain PyTorch versions of the port's kernels.

Port of ``repro.kernels.ref``.  These are what the kernel wrappers run on
CPU tensors, and what ``chip_smoke.py`` holds each CUDA kernel against on
the card.  The traversal and expand-merge versions repeat the CUDA kernels'
summation order (``lane_dot``), so on the same inputs they give the
kernels' bits; against the JAX reference, distances agree within float
noise and ids, flags, visited bits and counters exactly.  The candidate
merge does no arithmetic and is bit-equal to both.  The attention version
is a full fp32 softmax, not the kernel's tiled one: the two agree within
float rounding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core import traversal as T

LANES = 32
BIG = 3.0e38  # +inf stand-in of the build and expand-merge (reference BIG)


def lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_k a_k·b_k over the last dim, summed in the traversal kernel's order
    (``csrc/traversal.cu``): 32 lane partials — lane l adds the products of
    k = l, l+32, ... in turn, each multiply and add rounded on its own —
    then the warp's xor-butterfly halving tree.  Elementwise IEEE float32
    ops in a fixed order, so the kernel and this plain version give the same
    bits on any device.  ``a`` and ``b`` broadcast."""
    pad = (-a.shape[-1]) % LANES
    a = F.pad(a.float(), (0, pad)).unflatten(-1, (-1, LANES))
    b = F.pad(b.float(), (0, pad)).unflatten(-1, (-1, LANES))
    acc = a[..., 0, :] * b[..., 0, :]
    for c in range(1, a.shape[-2]):
        acc = acc + a[..., c, :] * b[..., c, :]
    w = LANES
    while w > 1:
        w //= 2
        acc = acc[..., :w] + acc[..., w:2 * w]
    return acc[..., 0]


def fes_distances_ref(q_grouped: torch.Tensor, entries: torch.Tensor, *,
                      scale: torch.Tensor = None,
                      codebook: torch.Tensor = None) -> torch.Tensor:
    """(r, QC, d) x (r, C, ·) -> (r, QC, C) squared euclidean, fp32, no
    clamp (like the reference kernel).  Entries are fp32, bf16 or int8
    (``scale`` (d,) multiplies int8 codes), nibble-packed int4 (``scale``
    wider than the stored rows: unpacked to 2·hp, scale padded with 1.0,
    queries with zeros) or pq codes (``codebook`` (d, m·ksub): ``qn +
    Σ_s lut[s·ksub + code_s]``, s ascending, with ``quant.pq_lut``)."""
    q = q_grouped.float()
    if codebook is not None:                              # K5: pq
        lut = quant.pq_lut(q.reshape(-1, q.shape[-1]), codebook)
        lut = lut.reshape(q.shape[:2] + lut.shape[-1:])   # (r, QC, m·ksub)
        m = entries.shape[-1]
        ksub = lut.shape[-1] // m
        shape = q.shape[:2] + entries.shape[1:2]          # (r, QC, C)
        acc = (q * q).sum(-1)[..., :, None].expand(shape)
        for s in range(m):                                # s ascending
            col = ksub * s + entries[:, None, :, s].long()
            acc = acc + lut.gather(2, col.expand(shape))
        return acc
    q = pad_query(q, entries, scale)
    e = decode_lanes(entries, scale)
    qn = (q * q).sum(-1)[..., :, None]
    en = (e * e).sum(-1)[..., None, :]
    return qn + en - 2.0 * torch.einsum("rqd,rcd->rqc", q, e)


def _decoded_width(table: torch.Tensor, scale: torch.Tensor = None) -> int:
    packed = scale is not None and table.shape[-1] < scale.shape[-1]
    return 2 * table.shape[-1] if packed else table.shape[-1]


def decode_lanes(rows: torch.Tensor, scale: torch.Tensor = None
                 ) -> torch.Tensor:
    """Rows of a dense or int4 table as the kernels decode them: fp32 at
    the decoded width, one multiply by the scale per element where there
    is a scale.  int4 rows unpack to both nibble planes (2·hp dims; the
    scale pads with 1.0 and the pad nibbles decode to exact zeros)."""
    if _decoded_width(rows, scale) != rows.shape[-1]:
        rows = quant.int4_unpack(rows)
    e = rows.float()
    return e if scale is None else e * pad_scale(scale, rows)


def _pad_to(x: torch.Tensor, width: int, value: float = 0.0) -> torch.Tensor:
    x = x.float()
    return x if x.shape[-1] == width else F.pad(x, (0, width - x.shape[-1]),
                                                value=value)


def pad_query(q: torch.Tensor, table: torch.Tensor,
              scale: torch.Tensor = None) -> torch.Tensor:
    """fp32 queries zero-padded to the decoded width of ``table``."""
    return _pad_to(q, _decoded_width(table, scale))


def pad_scale(scale: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """An fp32 scale row one-padded to the decoded width of ``table``."""
    return _pad_to(scale, _decoded_width(table, scale), value=1.0)


def lane_sq(q: torch.Tensor, nv: torch.Tensor) -> torch.Tensor:
    """(B, d) x (B, M, d) -> (B, M): ``max(qn + vn − 2·dot, 0)`` with every
    sum in ``lane_dot``'s order."""
    qf, nv = q.float(), nv.float()
    return torch.clamp_min(lane_dot(qf, qf)[:, None] + lane_dot(nv, nv)
                           - 2.0 * lane_dot(qf[:, None, :], nv), 0.0)


def lane_pq_lut(q: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """``quant.pq_lut`` with its two sums in ``lane_dot``'s order: column j
    is ``lane_dot(cb_j, cb_j) − 2·lane_dot(q, cb_j)`` — the table the
    traversal kernel builds in shared memory.  (B, m·ksub)."""
    cbt = codebook.float().T                              # (m·ksub, dp)
    return lane_dot(cbt, cbt)[None, :] - 2.0 * lane_dot(
        q.float()[:, None, :], cbt[None])


def pilot_dist_fn(q: torch.Tensor, vec_table: torch.Tensor,
                  vec_scale: torch.Tensor = None,
                  vec_codebook: torch.Tensor = None):
    """``dist_fn`` for ``core.traversal.expand_round`` over a stored table
    of any encoding, in the traversal kernel's arithmetic: dense and int4
    rows decode (``decode_lanes``) and go through ``lane_sq``; pq rows
    score ``max(qn + Σ_s lut[s·ksub + code_s], 0)`` with s ascending on
    ``lane_pq_lut``.  The LUT and padded query are made once, for ``q``."""
    if vec_codebook is not None:                          # pq
        lut = lane_pq_lut(q, vec_codebook)
        qf = q.float()
        qn = lane_dot(qf, qf)[:, None]
        m = vec_table.shape[1]
        ksub = lut.shape[1] // m

        def dist_fn(_q, ids, fresh):
            codes = vec_table[ids.long()].long()          # (B, M, m)
            acc = qn.expand(ids.shape)
            for s in range(m):
                acc = acc + lut.gather(1, ksub * s + codes[..., s])
            return torch.clamp_min(acc, 0.0)
        return dist_fn

    qd = pad_query(q, vec_table, vec_scale)

    def dist_fn(_q, ids, fresh):
        return lane_sq(qd, decode_lanes(vec_table[ids.long()], vec_scale))
    return dist_fn


def _state(beam_id, beam_d, beam_ck, visited) -> T.SearchState:
    z = torch.zeros((beam_id.shape[0],), dtype=torch.int32,
                    device=beam_id.device)
    return T.SearchState(beam_id.to(torch.int32), beam_d, beam_ck, visited,
                         z, z, z)


def apply_tombstone(tombstone, nbr_table, beam_id, beam_d, n: int):
    """The reference's ``_apply_tombstone``: tombstoned adjacency targets
    become the sentinel ``n``, tombstoned beam entries id ``n`` at +inf.
    The identity for ``tombstone=None``."""
    if tombstone is None:
        return nbr_table, beam_id, beam_d
    nbr_table = T.sentinel_mask(tombstone, nbr_table, n)
    dead = tombstone[beam_id.long().clamp(0, n)]
    return (nbr_table, beam_id.masked_fill(dead, n),
            beam_d.masked_fill(dead, float("inf")))


def traversal_hop_ref(q, nbr_table, vec_table, beam_id, beam_d, beam_ck,
                      visited, n: int, *, width: int = 1,
                      visited_mode: str = "bloom", vec_scale=None,
                      vec_codebook=None, tombstone=None):
    """One full W-wide expansion round (top-W frontier select, gather,
    sequential-per-frontier visited filter, distances, stable beam merge):
    ``core.traversal``'s round body with ``pilot_dist_fn``, after
    ``apply_tombstone``.  Returns (new_id, new_d, new_ck, new_visited,
    fresh) with fresh (B, W·R)."""
    nbr_table, beam_id, beam_d = apply_tombstone(tombstone, nbr_table,
                                                 beam_id, beam_d, n)
    spec = T.TraversalSpec(ef=beam_id.shape[1], visited_mode=visited_mode,
                           frontier_width=width)
    dist_fn = pilot_dist_fn(q, vec_table, vec_scale, vec_codebook)
    st, fresh = T.expand_round(spec, _state(beam_id, beam_d, beam_ck, visited),
                               q, nbr_table, vec_table, n, dist_fn=dist_fn)
    return st.cand_id, st.cand_d, st.checked, st.visited, fresh


def pilot_search_ref(q, nbr_table, vec_table, beam_id, beam_d, beam_ck,
                     visited, n: int, *, rounds: int, width: int = 1,
                     visited_mode: str = "bloom", vec_scale=None,
                     vec_codebook=None, tombstone=None):
    """Run up to ``rounds`` W-wide expansion rounds (stopping at
    convergence) of ``traversal_hop_ref``'s round, after
    ``apply_tombstone``.  Returns (beam_id, beam_d, beam_ck, visited,
    n_dist, n_hops, n_exp) with the counters as (B,) int32 deltas, like the
    persistent kernel."""
    nbr_table, beam_id, beam_d = apply_tombstone(tombstone, nbr_table,
                                                 beam_id, beam_d, n)
    spec = T.TraversalSpec(ef=beam_id.shape[1], visited_mode=visited_mode,
                           frontier_width=width)
    dist_fn = pilot_dist_fn(q, vec_table, vec_scale, vec_codebook)
    st = T.run_to_convergence(
        lambda s: T.expand_round(spec, s, q, nbr_table, vec_table, n,
                                 dist_fn=dist_fn)[0],
        _state(beam_id, beam_d, beam_ck, visited), n, rounds)
    return (st.cand_id, st.cand_d, st.checked, st.visited, st.n_dist,
            st.n_hops, st.n_exp)


def _stable_argsort(key: torch.Tensor) -> torch.Tensor:
    if key.is_floating_point():
        key = key + 0.0              # -0.0 -> +0.0: the two compare equal
    return torch.sort(key, dim=1, stable=True).indices


def lexsort2(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Row-wise stable argsort by ``(primary, secondary)`` — ``jnp.lexsort(
    (secondary, primary))`` — as two stable sorts, the secondary key first.
    Floats compare as floats (``-0.0 == 0.0``, as in the reference's sort)."""
    o = _stable_argsort(secondary)
    return o.gather(1, _stable_argsort(primary.gather(1, o)))


def candidate_merge_ref(cand_ids, cand_d, prop_ids, prop_d, n: int):
    """One NN-descent merge (port of ``repro.kernels.ref.
    candidate_merge_ref``): the (B, K) incumbent lists with the (B, P)
    scored proposals, ids >= n dropped, deduplicated by id keeping the
    smallest distance, then the (distance, id) top-K.  Sentinel slots come
    back as id ``n`` with distance BIG.  The plain version of
    ``kernels.build_kernel.fused_candidate_merge``, and the merge that runs
    on CPU tensors."""
    K = cand_ids.shape[1]
    all_ids = torch.cat([cand_ids, prop_ids], dim=1)
    all_d = torch.cat([cand_d, prop_d], dim=1)
    bad = all_ids >= n
    all_d = torch.where(bad, BIG, all_d)
    all_ids = torch.where(bad, n, all_ids)
    perm = lexsort2(all_ids, all_d)                   # id first, then d
    sid = all_ids.gather(1, perm)
    sd = all_d.gather(1, perm)
    dup = torch.zeros_like(sid, dtype=torch.bool)
    dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
    bad = dup | (sid >= n)
    sd = torch.where(bad, BIG, sd)
    sid = torch.where(bad, n, sid)
    perm2 = lexsort2(sd, sid)[:, :K]                  # d first, tie by id
    return sid.gather(1, perm2), sd.gather(1, perm2)


def expand_merge_ref(q, nvecs, nids, fresh, beam_id, beam_d, beam_ck, n: int):
    """Score the fresh pre-gathered neighbours (``lane_sq``; BIG and id n
    for the others) and merge them into the (B, ef) beam by (distance, id),
    ties in position order.  Returns (ids, dists, checked) (B, ef).  Port of
    ``repro.kernels.ref.expand_merge_ref``; the plain version of
    ``kernels.topk_kernel.fused_expand_merge``."""
    ef = beam_id.shape[1]
    d = torch.where(fresh, lane_sq(q, nvecs), BIG)
    all_d = torch.cat([beam_d.float(), d], dim=1)
    all_id = torch.cat([beam_id.to(torch.int32),
                        torch.where(fresh, nids.to(torch.int32), n)], dim=1)
    all_ck = torch.cat([beam_ck.to(torch.bool), ~fresh], dim=1)
    take = lexsort2(all_d, all_id)[:, :ef]
    return all_id.gather(1, take), all_d.gather(1, take), all_ck.gather(1, take)


NEG_INF = -1e30  # masked-score value of the reference's attention


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Attention forward with the contract of ``repro.kernels.
    flash_attention.flash_attention_tpu``, computed without tiles: per
    (b, h) a full fp32 masked softmax of ``q·kᵀ·D^-½`` (causal: ``q_pos >=
    k_pos``, both starting at 0; masked scores ``NEG_INF``), times v, over
    ``max(l, 1e-30)``, in q's dtype.  Query head h reads key head ``h //
    (H // Hkv)``.  q (B, Sq, H, D); k, v (B, Sk, Hkv, D).  The plain version
    of ``kernels.flash_attention.flash_attention``."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, H // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(D))
    if causal:
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~keep, NEG_INF)
    if Sk:
        s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    l = p.sum(-1).permute(0, 3, 1, 2)[..., None]            # (B, Sq, Hkv, G, 1)
    return (o / l.clamp_min(1e-30)).reshape(B, Sq, H, D).to(q.dtype)

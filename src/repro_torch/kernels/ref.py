"""Plain PyTorch versions of the port's kernels (dense fp32 encoding).

Port of ``repro.kernels.ref``.  These are what the kernel wrappers run on
CPU tensors, and what ``chip_smoke.py`` holds each CUDA kernel against on
the card.  The traversal versions repeat the CUDA kernel's summation order
(``lane_dot``), so on the same inputs they give the kernel's bits; against
the JAX reference, distances agree within float noise and ids, flags,
visited bits and counters exactly.
"""

from __future__ import annotations

import torch

from repro_torch.core import traversal as T

LANES = 32


def lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_k a_k·b_k over the last dim, summed in the traversal kernel's order
    (``csrc/traversal.cu``): 32 lane partials — lane l adds the products of
    k = l, l+32, ... in turn, each multiply and add rounded on its own —
    then the warp's xor-butterfly halving tree.  Elementwise IEEE float32
    ops in a fixed order, so the kernel and this plain version give the same
    bits on any device.  ``a`` and ``b`` broadcast."""
    pad = (-a.shape[-1]) % LANES
    a = torch.nn.functional.pad(a.float(), (0, pad)).unflatten(-1, (-1, LANES))
    b = torch.nn.functional.pad(b.float(), (0, pad)).unflatten(-1, (-1, LANES))
    acc = a[..., 0, :] * b[..., 0, :]
    for c in range(1, a.shape[-2]):
        acc = acc + a[..., c, :] * b[..., c, :]
    w = LANES
    while w > 1:
        w //= 2
        acc = acc[..., :w] + acc[..., w:2 * w]
    return acc[..., 0]


def fes_distances_ref(q_grouped: torch.Tensor,
                      entries: torch.Tensor) -> torch.Tensor:
    """(r, QC, d) x (r, C, d) -> (r, QC, C) squared euclidean, fp32, as
    ``qn + en − 2·dot`` (no clamp, like the reference kernel)."""
    q = q_grouped.float()
    e = entries.float()
    qn = (q * q).sum(-1)[..., :, None]
    en = (e * e).sum(-1)[..., None, :]
    return qn + en - 2.0 * torch.einsum("rqd,rcd->rqc", q, e)


def lane_sq_dists(vec_table: torch.Tensor):
    """``dist_fn`` for ``core.traversal.expand_round``: ``max(qn + vn −
    2·dot, 0)`` with every sum in ``lane_dot``'s order."""
    def dist_fn(q, ids, fresh):
        qf = q.float()
        nv = vec_table[ids.long()].float()                # (B, W·R, d)
        return torch.clamp_min(lane_dot(qf, qf)[:, None] + lane_dot(nv, nv)
                               - 2.0 * lane_dot(qf[:, None, :], nv), 0.0)
    return dist_fn


def _state(beam_id, beam_d, beam_ck, visited) -> T.SearchState:
    z = torch.zeros((beam_id.shape[0],), dtype=torch.int32,
                    device=beam_id.device)
    return T.SearchState(beam_id.to(torch.int32), beam_d, beam_ck, visited,
                         z, z, z)


def traversal_hop_ref(q, nbr_table, vec_table, beam_id, beam_d, beam_ck,
                      visited, n: int, *, width: int = 1,
                      visited_mode: str = "bloom"):
    """One full W-wide expansion round (top-W frontier select, gather,
    sequential-per-frontier visited filter, distances, stable beam merge):
    ``core.traversal``'s round body with ``lane_sq_dists``.  Returns
    (new_id, new_d, new_ck, new_visited, fresh) with fresh (B, W·R)."""
    spec = T.TraversalSpec(ef=beam_id.shape[1], visited_mode=visited_mode,
                           frontier_width=width)
    st, fresh = T.expand_round(spec, _state(beam_id, beam_d, beam_ck, visited),
                               q, nbr_table, vec_table, n,
                               dist_fn=lane_sq_dists(vec_table))
    return st.cand_id, st.cand_d, st.checked, st.visited, fresh


def pilot_search_ref(q, nbr_table, vec_table, beam_id, beam_d, beam_ck,
                     visited, n: int, *, rounds: int, width: int = 1,
                     visited_mode: str = "bloom"):
    """Run up to ``rounds`` W-wide expansion rounds (stopping at
    convergence) of ``traversal_hop_ref``'s round.  Returns (beam_id, beam_d,
    beam_ck, visited, n_dist, n_hops, n_exp) with the counters as (B,)
    int32 deltas, like the persistent kernel."""
    spec = T.TraversalSpec(ef=beam_id.shape[1], visited_mode=visited_mode,
                           frontier_width=width)
    dist_fn = lane_sq_dists(vec_table)
    st = T.run_to_convergence(
        lambda s: T.expand_round(spec, s, q, nbr_table, vec_table, n,
                                 dist_fn=dist_fn)[0],
        _state(beam_id, beam_d, beam_ck, visited), n, rounds)
    return (st.cand_id, st.cand_d, st.checked, st.visited, st.n_dist,
            st.n_hops, st.n_exp)

"""Node allocation / release (paper §3.2.3), port of
``repro.core.resource_manager``, batched over scenarios.

Node state is one int32 tensor ``node_job[S, N]``: the occupying job id,
-1 when free, -2 when down for repair (the event layer,
``repro_torch.events``, parks unavailable free nodes there). Placement
takes only -1 nodes: first-free by prefix-sum rank over the free mask,
either in index order or in a caller-supplied node preference order (the
scheduler's coolest-hall-first order on a multi-hall plant). Release
frees only nodes of completed jobs and leaves -2 nodes down.
"""
from __future__ import annotations

import torch


def release_done(node_job: torch.Tensor, done_now: torch.Tensor) -> torch.Tensor:
    """Free every node whose occupying job just completed; a down (-2)
    node stays down. ``node_job`` i32[S, N], ``done_now`` bool[S, J]."""
    freed = (node_job >= 0) & torch.gather(done_now, 1,
                                           node_job.clamp(min=0).long())
    return torch.where(freed, -1, node_job)


def firstfree_mask(node_job: torch.Tensor, need: torch.Tensor) -> torch.Tensor:
    """bool[S, N] selecting the first ``need[s]`` free nodes of each row
    (a down -2 node is not free)."""
    free = node_job == -1
    rank = torch.cumsum(free, 1, dtype=torch.int32)
    return free & (rank <= need[:, None])


def firstfree_mask_ordered(node_job: torch.Tensor, need: torch.Tensor,
                           order: torch.Tensor) -> torch.Tensor:
    """bool[S, N] selecting the first ``need[s]`` free nodes *in preference
    order* (``order``: i64[S, N], a permutation of node indices per row;
    the identity reproduces ``firstfree_mask`` exactly)."""
    free_o = torch.gather(node_job == -1, 1, order)
    rank = torch.cumsum(free_o, 1, dtype=torch.int32)
    sel_o = free_o & (rank <= need[:, None])
    return torch.zeros_like(sel_o).scatter_(1, order, sel_o)


def place(node_job: torch.Tensor, sel: torch.Tensor, jid: torch.Tensor,
          do_place: torch.Tensor) -> torch.Tensor:
    """Assign job ``jid[s]`` to the nodes in ``sel[s]`` where ``do_place[s]``."""
    return torch.where(sel & do_place[:, None], jid.to(node_job.dtype)[:, None],
                       node_job)


def prepopulate(n_nodes: int, first_node: torch.Tensor, nodes: torch.Tensor,
                running0: torch.Tensor) -> torch.Tensor:
    """The initial i32[N] node_job map from jobs already running at sim
    start (paper §3.2.3 prepopulation). Spans are disjoint by construction;
    a delta encoding + cumsum fills them in O(J + N)."""
    J = first_node.shape[0]
    jid = torch.arange(J, dtype=torch.int32, device=first_node.device)
    val = torch.where(running0, jid + 1, 0)       # 0 == free sentinel
    start = torch.where(running0, first_node, 0).long()
    stop = torch.where(running0, first_node + nodes, 0).long()
    delta = torch.zeros((n_nodes + 1,), dtype=torch.int32,
                        device=first_node.device)
    delta.index_add_(0, start, val)
    delta.index_add_(0, stop, -val)
    return torch.cumsum(delta[:-1], 0, dtype=torch.int32) - 1   # -1 == free

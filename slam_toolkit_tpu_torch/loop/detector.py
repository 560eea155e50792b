"""Loop detection: BoW scoring against every keyframe + temporal consistency.

Counterpart of slam_toolkit_tpu/loop/detector.py (ref
src/loopdetector.cpp:38-154, src/pipeline_map.cpp:151-272): one query
scores against every keyframe slot in one reduction; minScore is
min_score_ratio times the best covisible neighbour's score, floored;
candidates must be old enough and not covisible. The accScore grouping
and the consistency groups are host arithmetic on numpy rows.
"""

from __future__ import annotations

from typing import List, NamedTuple, Set, Tuple

import numpy as np
import torch

from slam_toolkit_tpu_torch.config import LoopConfig
from slam_toolkit_tpu_torch.loop.vocab import TopWBow, bow_score
from slam_toolkit_tpu_torch.mapping.map_state import (MapState, at,
                                                      covisibility_counts,
                                                      covisibility_rows)


class LoopScores(NamedTuple):
    scores: torch.Tensor      # (F,) BoW similarity to each keyframe slot
    covis: torch.Tensor       # (F,) shared-mappoint counts with the query
    min_score: torch.Tensor   # () detection threshold
    candidates: torch.Tensor  # (F,) bool raw candidate mask


def insertion_rank(m: MapState) -> torch.Tensor:
    """(F,) number of valid keyframes inserted before each slot (invalid
    slots rank after every valid one)."""
    fid = torch.where(m.kf_valid, m.kf_frame_id,
                      torch.full_like(m.kf_frame_id,
                                      torch.iinfo(torch.int32).max))
    return torch.sum(fid[None, :] < fid[:, None], dim=1)


def score_query(m: MapState, bow_db, bow_query, kf_slot,
                cfg: LoopConfig) -> LoopScores:
    """Score one keyframe's BoW against the whole database (kf_slot a
    host int or a 0-dim tensor on the map's device)."""
    F = m.kf_valid.shape[0]
    slots = torch.arange(F, device=m.kf_valid.device)
    scores = bow_score(bow_query, bow_db)
    valid = m.kf_valid & (slots != kf_slot)
    scores = torch.where(valid, scores, torch.full_like(scores, -1.0))
    covis = covisibility_counts(m, kf_slot)
    return _detect(m, scores, covis, valid, at(insertion_rank(m), kf_slot),
                   cfg)


def _detect(m: MapState, scores, covis, valid, rank_q,
            cfg: LoopConfig) -> LoopScores:
    """minScore from the best covisible neighbour, and the candidates:
    valid, not covisible, min_kf_gap insertions older than the query
    (rank_q, its insertion rank), scoring at least minScore. A leading
    axis of queries on scores, covis, valid and rank_q."""
    neighbor = valid & (covis >= cfg.min_covisibility)
    best_neighbor = torch.amax(torch.where(neighbor, scores,
                                           torch.zeros_like(scores)), dim=-1)
    min_score = torch.clamp(cfg.min_score_ratio * best_neighbor,
                            min=cfg.min_score_floor)
    rank = insertion_rank(m)
    old_enough = rank <= rank_q[..., None] - cfg.min_kf_gap
    candidates = (valid & ~neighbor & old_enough &
                  (scores >= torch.clamp(min_score, min=1e-6)[..., None]))
    return LoopScores(scores=scores, covis=covis, min_score=min_score,
                      candidates=candidates)


def score_queries(m: MapState, bow_db, queries, kf_slots: torch.Tensor,
                  cfg: LoopConfig) -> LoopScores:
    """score_query for K keyframes at once: queries (K, W) dense rows or
    a TopWBow of (K, w) rows, kf_slots (K,) on the map's device; each
    field gains a leading K. The dense scores are one (K, F) reduction,
    the covisibility rows a pass over kf_obs each (covisibility_rows)."""
    F = m.kf_valid.shape[0]
    K = kf_slots.shape[0]
    slots = torch.arange(F, device=m.kf_valid.device)
    if isinstance(bow_db, TopWBow):
        scores = torch.stack([bow_score(TopWBow(queries.words[k],
                                                queries.weights[k]), bow_db)
                              for k in range(K)])
    else:
        scores = 1.0 - 0.5 * torch.sum(
            torch.abs(bow_db[None] - queries[:, None]), dim=-1)
    valid = m.kf_valid[None] & (slots[None] != kf_slots[:, None])
    scores = torch.where(valid, scores, torch.full_like(scores, -1.0))
    covis = covisibility_rows(m, kf_slots, torch.ones_like(valid[:, 0]))
    rank_q = insertion_rank(m).index_select(0, kf_slots.long())
    return _detect(m, scores, covis, valid, rank_q, cfg)


def acc_score_retrieval(scores: np.ndarray, cand_slots: np.ndarray,
                        covis_rows: np.ndarray, accept_ratio: float = 0.75,
                        group_size: int = 10):
    """Covisibility-group score accumulation (ref
    src/pipeline_map.cpp:224-269): each candidate's score plus those of
    its top-`group_size` covisible keyframes that are candidates too;
    groups above accept_ratio * best kept, each represented by its best
    member. Returns (kept_slots, kept_acc), by descending group score."""
    cand_set = set(int(c) for c in cand_slots)
    reps, accs = [], []
    for ci, cs in enumerate(cand_slots):
        cov = covis_rows[ci].copy()
        cov[int(cs)] = 0
        top = np.argsort(-cov)[:group_size]
        top = top[cov[top] > 0]
        acc = float(scores[int(cs)])
        best_slot, best_score = int(cs), float(scores[int(cs)])
        for j in top:
            if int(j) in cand_set:
                acc += float(scores[int(j)])
                if float(scores[int(j)]) > best_score:
                    best_slot, best_score = int(j), float(scores[int(j)])
        reps.append(best_slot)
        accs.append(acc)
    if not reps:
        return np.empty((0,), np.int64), np.empty((0,))
    accs = np.asarray(accs)
    keep = accs > accept_ratio * accs.max()
    out, seen = [], set()
    for r, a in sorted(zip(np.asarray(reps)[keep], accs[keep]),
                       key=lambda t: -t[1]):
        if int(r) not in seen:
            seen.add(int(r))
            out.append((int(r), float(a)))
    return (np.asarray([o[0] for o in out], np.int64),
            np.asarray([o[1] for o in out]))


class ConsistencyTracker:
    """Temporal-consistency groups (ref src/loopdetector.cpp:92-146): a
    candidate is accepted once its covisibility group has intersected a
    previous detection's group for `threshold` consecutive keyframes."""

    def __init__(self, threshold: int):
        self.threshold = threshold
        self.groups: List[Tuple[Set[int], int]] = []   # (kf set, streak)

    def update(self, candidate_groups: List[Set[int]]) -> List[int]:
        """candidate_groups: per candidate, {candidate + its covisible
        neighbours}. Returns the indices of the now-consistent ones."""
        accepted = []
        new_groups: List[Tuple[Set[int], int]] = []
        for ci, grp in enumerate(candidate_groups):
            streak = 0
            for prev, n in self.groups:
                if grp & prev:
                    streak = max(streak, n + 1)
            new_groups.append((grp, streak))
            if streak >= self.threshold:
                accepted.append(ci)
        self.groups = new_groups
        return accepted

    def reset(self):
        self.groups = []

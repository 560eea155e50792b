"""The vocabulary tree's trainer, numpy.

A frozen copy of the port's hierarchical k-medoids trainer (binary
descriptors, bitwise-majority centres; DBoW2's TemplatedVocabulary::
create with FORB's meanValue), so that a later change to the port's
trainer cannot move the vocabulary a configuration's recipe builds. It
imports nothing of slam_toolkit_tpu_torch; benchmark/tests holds its
output equal to the port's train() on the same descriptors.

train() returns the tree as numpy arrays; save() writes them in the
port's npz layout (nodes, children, word_id, weights, k, levels), which
the port's public loop.vocab.load reads.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class Tree(NamedTuple):
    nodes: np.ndarray        # (n_nodes, 8) uint32 centroid descriptors
    children: np.ndarray     # (n_nodes, k) int32 child ids, self-padded
    word_id: np.ndarray      # (n_nodes,) int32 leaf word id, -1 internal
    weights: np.ndarray      # (num_words,) float32 IDF weights
    k: int
    levels: int


def _hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M, 8) x (N, 8) uint32 -> (M, N) int distances."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _majority_center(desc: np.ndarray) -> np.ndarray:
    """Bitwise-majority 'mean' of packed descriptors (FORB::meanValue)."""
    bits = np.unpackbits(desc.view(np.uint8), axis=-1)   # (N, 256)
    maj = (bits.sum(0) * 2 >= bits.shape[0]).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmeans_binary(desc: np.ndarray, k: int, rng, iters: int = 8):
    """k-medoids-style clustering of binary descriptors."""
    n = desc.shape[0]
    if n <= k:
        return desc.copy(), np.arange(n) % max(n, 1)
    centers = desc[rng.choice(n, k, replace=False)]
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        dist = _hamming(desc, centers)
        assign = dist.argmin(1)
        for c in range(k):
            sel = assign == c
            if sel.any():
                centers[c] = _majority_center(desc[sel])
            else:  # re-seed a dead cluster at the farthest point
                far = dist.min(1).argmax()
                centers[c] = desc[far]
    return centers, assign


def _words(desc, nodes, children, word_id, levels, chunk: int = 16384):
    """Each descriptor's word: the greedy descent from the root."""
    out = np.empty(desc.shape[0], np.int64)
    for j0 in range(0, desc.shape[0], chunk):   # bounded unpackbits blowup
        d0 = desc[j0:j0 + chunk]
        cur = np.zeros(d0.shape[0], np.int64)
        for _ in range(levels):
            ch = children[cur]                       # (N, k)
            x = nodes[ch] ^ d0[:, None, :]
            d = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
            # self-children (padding) never win over real children
            d = np.where(ch == cur[:, None], 1 << 30, d)
            nxt = ch[np.arange(d0.shape[0]), d.argmin(1)]
            cur = np.where(word_id[cur] >= 0, cur, nxt)  # stop at leaves
        out[j0:j0 + chunk] = word_id[cur]
    return out


def train(descriptors: np.ndarray, k: int = 10, levels: int = 4,
          seed: int = 0, max_train: int = 100_000) -> Tree:
    """The tree of a (N, 8) uint32 training corpus (int32 words are taken
    bit for bit): at most max_train descriptors drawn from it with the
    seed's generator, split k ways at each of `levels` levels, leaves
    numbered in node order, IDF weights from the corpus."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors)
    desc = desc.view(np.uint32) if desc.dtype == np.int32 else \
        np.asarray(desc, np.uint32)
    if desc.shape[0] > max_train:
        desc = desc[rng.choice(desc.shape[0], max_train, replace=False)]

    nodes = [np.zeros(8, np.uint32)]          # root (unused centroid)
    children = [np.full(k, -1, np.int64)]
    level_of = [0]

    def grow(node_id: int, data: np.ndarray, level: int):
        if level == levels or data.shape[0] == 0:
            return
        centers, assign = _kmeans_binary(data, k, rng)
        for c in range(min(k, centers.shape[0])):
            cid = len(nodes)
            nodes.append(centers[c])
            children.append(np.full(k, -1, np.int64))
            level_of.append(level + 1)
            children[node_id][c] = cid
            grow(cid, data[assign == c], level + 1)

    grow(0, desc, 0)

    # leaves (at the last level, or childless) get word ids in node order
    n_nodes = len(nodes)
    word_id = np.full(n_nodes, -1, np.int64)
    wid = 0
    for i in range(n_nodes):
        if level_of[i] == levels or (i > 0 and (children[i] < 0).all()):
            word_id[i] = wid
            wid += 1
    # empty child slots point at their node, so the descent stays put
    ch = np.stack(children)
    for i in range(n_nodes):
        ch[i][ch[i] < 0] = i

    nodes_np = np.stack(nodes)
    words = _words(desc, nodes_np, ch, word_id, levels)
    counts = np.bincount(words[words >= 0], minlength=wid).astype(np.float64)
    idf = np.maximum(np.log(max(desc.shape[0], 1) /
                            np.maximum(counts, 1.0)), 1e-3)
    return Tree(nodes=nodes_np, children=ch.astype(np.int32),
                word_id=word_id.astype(np.int32),
                weights=idf.astype(np.float32), k=int(k), levels=int(levels))


def save(tree: Tree, path: str) -> None:
    """The tree as an npz file in the port's layout, written whole or not
    at all (a temporary name, then a rename)."""
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, nodes=tree.nodes, children=tree.children,
                        word_id=tree.word_id, weights=tree.weights,
                        k=tree.k, levels=tree.levels)
    os.replace(tmp, path)

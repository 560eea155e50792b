"""Hierarchical binary visual vocabulary: train (host) + transform (device).

Counterpart of slam_toolkit_tpu/loop/vocab.py (ref DBoW2
TemplatedVocabulary). Training (hierarchical k-medoids with
bitwise-majority centres), the full-tree synthesis and the file formats
(npz and DBoW2 text) are numpy, copied from the JAX package; a test
holds the copies' outputs equal to the originals'. The runtime half runs
on tensors:

- ``descriptor_words``: the greedy tree descent, L gather + argmin-over-k
  steps over every descriptor of a frame at once;
- dense BoW: (num_words,) L1-normalized TF-IDF rows scored by the DBoW2
  L1 similarity 1 - 0.5 |q - d|_1; bow_rows takes R frames at once;
- top-w sparse BoW (ORBvoc-scale vocabularies): per-frame rows of the w
  heaviest (word, weight) entries sorted by word id. ``topw_l1_score``
  is a sorted intersection (torch.searchsorted of the query's w words in
  each row's w sorted words, (F, w log w) work), where the JAX package
  broadcasts an (F, w, w) equality join that XLA fuses away; eager torch
  would materialize it (1 GB at F=1024, w=512). Both sum min(q, d) over
  the matched words.

Descriptor words are int32 here (uint32 in the JAX package, the same
bits); ``Vocabulary`` holds tensors on one device (``to_device``). The
database is written functionally (``db_set``, as in the JAX package) or
in place in a buffer with a dump row (``db_write_``), which a CUDA graph
can hold.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Vocabulary(NamedTuple):
    """Flattened vocabulary tree (levels of equal branching k)."""
    nodes: torch.Tensor      # (n_nodes, 8) int32 node centroid descriptors
    children: torch.Tensor   # (n_nodes, k) int64 child node ids
    word_id: torch.Tensor    # (n_nodes,) int64 leaf word id, -1 internal
    weights: torch.Tensor    # (num_words,) float32 IDF weights
    k: int
    levels: int

    @property
    def num_words(self) -> int:
        return self.weights.shape[0]


def _from_numpy(nodes, children, word_id, weights, k, levels,
                device="cpu") -> Vocabulary:
    return Vocabulary(
        nodes=torch.from_numpy(np.array(nodes, np.uint32).view(np.int32))
        .to(device),
        children=torch.from_numpy(np.array(children, np.int64)).to(device),
        word_id=torch.from_numpy(np.array(word_id, np.int64)).to(device),
        weights=torch.from_numpy(np.array(weights, np.float32)).to(device),
        k=int(k), levels=int(levels))


def to_device(voc: Vocabulary, device) -> Vocabulary:
    return voc._replace(nodes=voc.nodes.to(device),
                        children=voc.children.to(device),
                        word_id=voc.word_id.to(device),
                        weights=voc.weights.to(device))


def to_numpy(voc: Vocabulary):
    """(nodes uint32, children, word_id, weights) as numpy arrays."""
    return (voc.nodes.cpu().numpy().view(np.uint32),
            voc.children.cpu().numpy(), voc.word_id.cpu().numpy(),
            voc.weights.cpu().numpy())


# ---------------------------------------------------------------------------
# training (host-side numpy, copied from the JAX package)
# ---------------------------------------------------------------------------

def _popcount_rows(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
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
        dist = _hamming_np(desc, centers)
        assign = dist.argmin(1)
        for c in range(k):
            sel = assign == c
            if sel.any():
                centers[c] = _majority_center(desc[sel])
            else:  # re-seed dead cluster at the farthest point
                far = dist.min(1).argmax()
                centers[c] = desc[far]
    return centers, assign


def train(descriptors: np.ndarray, k: int = 10, levels: int = 4,
          seed: int = 0, max_train: int = 100_000) -> Vocabulary:
    """Build the tree from a (N, 8) uint32 training corpus (int32 words
    are taken bit for bit). Returns a CPU vocabulary."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors)
    desc = desc.view(np.uint32) if desc.dtype == np.int32 else \
        np.asarray(desc, np.uint32)
    if desc.shape[0] > max_train:
        desc = desc[rng.choice(desc.shape[0], max_train, replace=False)]

    nodes = [np.zeros(8, np.uint32)]          # root (unused centroid)
    children = [np.full(k, -1, np.int64)]
    level_of = [0]
    word_of = [-1]

    def grow(node_id: int, data: np.ndarray, level: int):
        if level == levels or data.shape[0] == 0:
            return
        centers, assign = _kmeans_binary(data, k, rng)
        for c in range(min(k, centers.shape[0])):
            cid = len(nodes)
            nodes.append(centers[c])
            children.append(np.full(k, -1, np.int64))
            level_of.append(level + 1)
            word_of.append(-1)
            children[node_id][c] = cid
            grow(cid, data[assign == c], level + 1)

    grow(0, desc, 0)

    # assign word ids to leaves (level == levels or childless nodes)
    n_nodes = len(nodes)
    word_id = np.full(n_nodes, -1, np.int64)
    wid = 0
    for i in range(n_nodes):
        is_leaf = (level_of[i] == levels) or \
            (i > 0 and (children[i] < 0).all())
        if is_leaf:
            word_id[i] = wid
            wid += 1
    # childless internal nodes: point empty child slots at self so the
    # descent loop stays well-defined (it will stop progressing)
    ch = np.stack(children)
    for i in range(n_nodes):
        ch[i][ch[i] < 0] = i

    # IDF weights from the training corpus
    words = _transform_words_np(desc, np.stack(nodes), ch, word_id,
                                k, levels)
    counts = np.bincount(words[words >= 0], minlength=wid).astype(np.float64)
    n_docs = max(desc.shape[0], 1)
    idf = np.log(n_docs / np.maximum(counts, 1.0))
    idf = np.maximum(idf, 1e-3)
    return _from_numpy(np.stack(nodes), ch.astype(np.int32),
                       word_id.astype(np.int32), idf.astype(np.float32),
                       k, levels)


def _transform_words_np(desc, nodes, children, word_id, k, levels,
                        chunk: int = 16384):
    out = np.empty(desc.shape[0], np.int64)
    for j0 in range(0, desc.shape[0], chunk):   # bounded unpackbits blowup
        d0 = desc[j0:j0 + chunk]
        cur = np.zeros(d0.shape[0], np.int64)
        for _ in range(levels):
            ch = children[cur]                       # (N, k)
            cand = nodes[ch]                         # (N, k, 8)
            x = cand ^ d0[:, None, :]
            d = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
            # self-children (padding) must never win over real children
            d = np.where(ch == cur[:, None], 1 << 30, d)
            nxt = ch[np.arange(d0.shape[0]), d.argmin(1)]
            cur = np.where(word_id[cur] >= 0, cur, nxt)  # stop at leaves
        out[j0:j0 + chunk] = word_id[cur]
    return out


def synthesize(k: int = 10, levels: int = 6, seed: int = 0,
               corpus: np.ndarray = None,
               chunk: int = 131072) -> Vocabulary:
    """A FULL k-ary tree built directly (the reference's ORBvoc operating
    point is k=10, L=6): each child centroid is its parent's with a
    level-halving fraction of bits flipped (0.5, 0.25, ...). corpus:
    optional (N, 8) uint32 descriptors for the leaves' IDF weights,
    else 1.0."""
    rng = np.random.default_rng(seed)
    counts = [k ** l for l in range(levels + 1)]
    starts = np.cumsum([0] + counts)
    n = int(starts[-1])
    nodes = np.zeros((n, 8), np.uint32)
    children = np.zeros((n, k), np.int64)
    for lvl in range(levels):
        s, e = int(starts[lvl]), int(starts[lvl + 1])
        cs, ce = int(starts[lvl + 1]), int(starts[lvl + 2])
        parents = np.repeat(nodes[s:e], k, axis=0)
        p = 0.5 * (0.5 ** lvl)
        m = ce - cs
        for j0 in range(0, m, chunk):            # bounded RNG transient
            j1 = min(m, j0 + chunk)
            bits = rng.random((j1 - j0, 256), dtype=np.float32) < p
            mask = np.packbits(bits, axis=-1).view(np.uint32)
            nodes[cs + j0:cs + j1] = parents[j0:j1] ^ mask
        children[s:e] = cs + np.arange(e - s)[:, None] * k \
            + np.arange(k)[None, :]
    leaves = np.arange(int(starts[levels]), n)
    word_id = np.full(n, -1, np.int64)
    word_id[leaves] = np.arange(leaves.size)
    children[leaves] = leaves[:, None]           # self-padding at leaves
    if corpus is not None:
        corpus = np.asarray(corpus, np.uint32)
        words = _transform_words_np(corpus, nodes, children, word_id,
                                    k, levels)
        cnt = np.bincount(words[words >= 0],
                          minlength=leaves.size).astype(np.float64)
        weights = np.maximum(
            np.log(max(corpus.shape[0], 1) / np.maximum(cnt, 1.0)),
            1e-3).astype(np.float32)
    else:
        weights = np.ones(leaves.size, np.float32)
    return _from_numpy(nodes, children, word_id, weights, k, levels)


def save(voc: Vocabulary, path: str) -> None:
    nodes, children, word_id, weights = to_numpy(voc)
    np.savez_compressed(path, nodes=nodes, children=children.astype(np.int32),
                        word_id=word_id.astype(np.int32), weights=weights,
                        k=voc.k, levels=voc.levels)


def save_dbow2_text(voc: Vocabulary, path: str) -> None:
    """Serialize in DBoW2's text format (TemplatedVocabulary::saveToTextFile,
    ref thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h): header "k L s w",
    then one line per non-root node: parent_id is_leaf d0..d31 weight.
    Node ids are implicit (file order, root excluded)."""
    nodes, children, word_id, weights = to_numpy(voc)
    nodes = np.ascontiguousarray(nodes)
    n = nodes.shape[0]
    parent = np.full(n, -1, np.int64)
    for i in range(n):
        for c in children[i]:
            if c != i and parent[c] < 0:
                parent[c] = i
    order = list(range(1, n))                       # root excluded
    file_id = {nid: fi + 1 for fi, nid in enumerate(order)}
    file_id[0] = 0
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.levels} 0 0\n")      # L1 scoring, TF-IDF
        for nid in order:
            d_bytes = nodes[nid].view(np.uint8)
            is_leaf = 1 if word_id[nid] >= 0 else 0
            w = weights[word_id[nid]] if is_leaf else 0.0
            f.write(f"{file_id[parent[nid]] if parent[nid] >= 0 else 0} "
                    f"{is_leaf} " + " ".join(str(int(b)) for b in d_bytes) +
                    f" {float(w)}\n")


def load_dbow2_text(path: str) -> Vocabulary:
    """Parse a DBoW2 text vocabulary (header "k L scoring weighting",
    then per-node lines "parent is_leaf <32 descriptor bytes> weight")."""
    with open(path, "r") as f:
        header = f.readline().split()
        k, levels = int(header[0]), int(header[1])
        body = np.fromfile(f, sep=" ")
    ncols = 2 + 32 + 1
    if body.size % ncols:
        raise ValueError(f"malformed DBoW2 text file: {body.size} tokens "
                         f"is not a multiple of {ncols}")
    rows = body.reshape(-1, ncols)
    n_file = rows.shape[0]
    n = n_file + 1                                  # + root
    parent = np.concatenate([[-1], rows[:, 0].astype(np.int64)])
    is_leaf = np.concatenate([[False], rows[:, 1] > 0.5])
    desc = np.zeros((n, 8), np.uint32)
    desc[1:] = np.ascontiguousarray(
        rows[:, 2:34].astype(np.uint8)).view(np.uint32)
    w_file = np.concatenate([[0.0], rows[:, 34]])

    children = np.full((n, k), -1, np.int64)
    slot = np.zeros(n, np.int64)
    for i in range(1, n):
        p = parent[i]
        if slot[p] >= k:
            raise ValueError(f"node {p} has more than k={k} children")
        children[p, slot[p]] = i
        slot[p] += 1
    # word ids for leaves in file order (DBoW2 createWords order)
    word_id = np.full(n, -1, np.int64)
    leaf_ids = np.flatnonzero(is_leaf)
    word_id[leaf_ids] = np.arange(leaf_ids.size)
    weights = np.maximum(w_file[leaf_ids], 1e-3).astype(np.float32)
    for i in range(n):
        children[i][children[i] < 0] = i            # self-padding
    return _from_numpy(desc, children, word_id, weights, k, levels)


def load(path: str) -> Vocabulary:
    z = np.load(path)
    return _from_numpy(z["nodes"], z["children"], z["word_id"],
                       z["weights"], int(z["k"]), int(z["levels"]))


# ---------------------------------------------------------------------------
# runtime (tensors)
# ---------------------------------------------------------------------------

def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int32 words, in int64 arithmetic masked to 32 bits."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def descriptor_words(voc: Vocabulary, desc: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """(K, 8) descriptors -> (K,) int64 word ids (-1 for invalid slots)."""
    K = desc.shape[0]
    cur = torch.zeros((K,), dtype=torch.int64, device=desc.device)
    for _ in range(voc.levels):
        ch = voc.children[cur]                     # (K, k)
        x = voc.nodes[ch] ^ desc[:, None, :]       # (K, k, 8)
        d = torch.sum(_popcount32(x), dim=-1)
        d = torch.where(ch == cur[:, None], torch.full_like(d, 1 << 30), d)
        nxt = torch.gather(ch, 1, torch.argmin(d, dim=1)[:, None])[:, 0]
        cur = torch.where(voc.word_id[cur] >= 0, cur, nxt)
    words = voc.word_id[cur]
    return torch.where(valid, words, torch.full_like(words, -1))


def bow_vector(voc: Vocabulary, desc: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Dense L1-normalized TF-IDF BoW vector (num_words,). The histogram
    is an integer bincount, so it is exact on any device."""
    words = descriptor_words(voc, desc, valid)
    w = voc.num_words
    safe = torch.where(words >= 0, words, torch.full_like(words, w))
    hist = torch.bincount(safe, minlength=w + 1)[:w].float()
    vec = hist * voc.weights
    return vec / torch.clamp(torch.sum(torch.abs(vec)), min=1e-12)


def l1_score(query: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity 1 - 0.5 |q - d|_1 of one vector against (F, W)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(database - query[None, :]), dim=-1)


class TopWBow(NamedTuple):
    """Per-frame (or batched) sparse BoW rows, sorted by word id."""
    words: torch.Tensor     # (..., w) int64, pad = num_words
    weights: torch.Tensor   # (..., w) float32, pad = 0


def bow_topw(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor,
             top_w: int) -> TopWBow:
    """Sparse top-w L1-normalized TF-IDF BoW of one frame, normalized over
    the full vector before truncation; all work in K-space (K = #
    descriptors): a sorted-run histogram and a stable top-w (lax.top_k's
    index order on ties)."""
    return _topw_of_words(voc, descriptor_words(voc, desc, valid), top_w)


def _topw_of_words(voc: Vocabulary, words: torch.Tensor,
                   top_w: int) -> TopWBow:
    """bow_topw from a frame's (K,) word ids (-1 for invalid slots)."""
    K = words.shape[0]
    w = voc.num_words
    safe = torch.where(words >= 0, words, torch.full_like(words, w))
    sw = torch.sort(safe).values                     # runs of equal words
    head = torch.ones_like(sw, dtype=torch.bool)
    head[1:] = sw[1:] != sw[:-1]
    run = torch.cumsum(head.long(), 0) - 1           # (K,) run index
    counts = torch.zeros((K,), dtype=torch.int64, device=words.device) \
        .scatter_add_(0, run, (sw < w).long()).float()
    # representative word per run: every writer of a run writes the same
    rep = torch.full((K,), w, dtype=torch.int64,
                     device=words.device).scatter_(0, run, sw)
    idf = torch.cat([voc.weights, voc.weights.new_zeros(1)])[rep]
    vec = counts * idf
    vec = vec / torch.clamp(torch.sum(vec), min=1e-12)
    kk = min(top_w, K)
    top_vals, top_idx = torch.sort(vec, descending=True, stable=True)
    top_vals, top_idx = top_vals[:kk], top_idx[:kk]
    top_words = rep[top_idx]
    if kk < top_w:
        top_vals = torch.cat([top_vals, top_vals.new_zeros(top_w - kk)])
        top_words = torch.cat([top_words,
                               top_words.new_full((top_w - kk,), w)])
    wi = torch.where(top_vals > 0, top_words, torch.full_like(top_words, w))
    order = torch.sort(wi, stable=True).indices
    return TopWBow(words=wi[order], weights=top_vals[order])


def topw_l1_score(query: TopWBow, db: TopWBow) -> torch.Tensor:
    """(F,) L1 similarity of one sparse row against many: each query word
    is looked up in each row's sorted words (searchsorted) and min(q, d)
    summed over the matches. Pad words (weight 0) contribute 0 whichever
    way they match, as in the JAX package's broadcast join."""
    F, w = db.words.shape
    q = query.words[None, :].expand(F, -1).contiguous()
    pos = torch.clamp(torch.searchsorted(db.words.contiguous(), q), max=w - 1)
    hit = torch.gather(db.words, 1, pos) == q
    dv = torch.gather(db.weights, 1, pos)
    contrib = torch.where(hit, torch.minimum(dv, query.weights[None, :]),
                          torch.zeros_like(dv))
    return torch.sum(contrib, dim=1)


def use_sparse(voc: Vocabulary, cfg_loop) -> bool:
    """The BoW backend: explicit bow_mode, else dense up to
    bow_dense_max_words, sparse beyond."""
    mode = getattr(cfg_loop, "bow_mode", "auto")
    if mode == "dense":
        return False
    if mode == "topw":
        return True
    return voc.num_words > getattr(cfg_loop, "bow_dense_max_words", 65536)


def make_bow_db(voc: Vocabulary, capacity: int, sparse: bool, top_w: int):
    """Empty keyframe BoW database for either backend, on voc's device."""
    dev = voc.weights.device
    if not sparse:
        return torch.zeros((capacity, voc.num_words), device=dev)
    return TopWBow(
        words=torch.full((capacity, top_w), voc.num_words, dtype=torch.int64,
                         device=dev),
        weights=torch.zeros((capacity, top_w), device=dev))


def bow_query(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor,
              sparse: bool, top_w: int):
    """One frame's BoW in the database's representation; desc (R, K, 8)
    and valid (R, K) give R rows at once (bow_rows)."""
    if desc.dim() == 3:
        return bow_rows(voc, desc, valid, sparse, top_w)
    if not sparse:
        return bow_vector(voc, desc, valid)
    return bow_topw(voc, desc, valid, top_w)


def bow_rows(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor,
             sparse: bool, top_w: int):
    """The BoW of R frames (desc (R, K, 8), valid (R, K)): one tree
    descent over all R * K descriptors (each descriptor's word is its
    own), then dense (R, num_words) rows from one integer histogram with
    the rows offset (a scatter-add: torch.bincount on a card reads its
    size back), each L1-normalized, or R top-w rows (TopWBow of (R,
    w))."""
    R, K = valid.shape
    words = descriptor_words(voc, desc.reshape(R * K, 8),
                             valid.reshape(-1)).reshape(R, K)
    w = voc.num_words
    if sparse:
        rows = [_topw_of_words(voc, words[r], top_w) for r in range(R)]
        return TopWBow(torch.stack([q.words for q in rows]),
                       torch.stack([q.weights for q in rows]))
    safe = torch.where(words >= 0, words, torch.full_like(words, w))
    base = torch.arange(R, device=desc.device)[:, None] * (w + 1)
    idx = (safe + base).reshape(-1)
    hist = torch.zeros((R * (w + 1),), dtype=torch.int64,
                       device=desc.device).scatter_add_(
        0, idx, torch.ones_like(idx))
    vec = hist.reshape(R, w + 1)[:, :w].float() * voc.weights
    return vec / torch.clamp(torch.sum(torch.abs(vec), dim=1, keepdim=True),
                             min=1e-12)


def bow_score(query, db) -> torch.Tensor:
    """(F,) L1 similarity of one query against the whole db."""
    if isinstance(db, TopWBow):
        return topw_l1_score(query, db)
    return l1_score(query, db)


def _set_rows(rows: torch.Tensor, slot, new: torch.Tensor) -> torch.Tensor:
    """rows with rows[slot] = new; slot an int, or a (B,) tensor whose
    entries >= F are dropped (a dump row past the end)."""
    if not torch.is_tensor(slot):
        out = rows.clone()
        out[int(slot)] = new
        return out
    ext = torch.cat([rows, rows[:1]])
    ext[torch.clamp(slot.long(), max=rows.shape[0])] = new
    return ext[:-1]


def db_set(db, slot, query):
    """Write one frame's BoW at `slot` (or a batch at (B,) slots); a new
    database (the JAX package's functional update)."""
    if isinstance(db, TopWBow):
        return TopWBow(words=_set_rows(db.words, slot, query.words),
                       weights=_set_rows(db.weights, slot, query.weights))
    return _set_rows(db, slot, query)


def make_bow_db_buffer(voc: Vocabulary, capacity: int, sparse: bool,
                       top_w: int):
    """An empty database with one dump row past the end (capacity + 1
    rows), for db_write_; db_rows gives the capacity rows the scoring
    reads."""
    return make_bow_db(voc, capacity + 1, sparse, top_w)


def db_rows(buf):
    """The database rows of a make_bow_db_buffer buffer (a view)."""
    if isinstance(buf, TopWBow):
        return TopWBow(buf.words[:-1], buf.weights[:-1])
    return buf[:-1]


def db_write_(buf, slots: torch.Tensor, query) -> None:
    """Write R frames' BoW rows (query: R dense rows or a TopWBow of R
    rows) at the (R,) device slots in place; a slot >= capacity writes
    the dump row, which nothing reads. No tensor is allocated for the
    database, so a CUDA graph can hold the write."""
    parts = zip(buf, query) if isinstance(buf, TopWBow) else ((buf, query),)
    for dst, src in parts:
        last = dst.shape[0] - 1
        dst.index_copy_(0, torch.clamp(slots.long(), max=last),
                        src.to(dst.dtype))

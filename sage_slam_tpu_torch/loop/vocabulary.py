"""BoW vocabulary: a hierarchical k-means tree in dense tensors (port of
sage_slam_tpu/loop/vocabulary.py).

The tree is a children table [num_nodes, k] padded with -1, node
descriptors [num_nodes, C], word weights and word ids per node. Every
feature descends in parallel: ``levels`` gather + argmin steps, then one
scatter-add into the dense BoW vector, L1-normalised. Scoring is DBoW2's
L1 score on L1-normalised vectors, s(v, w) = 1 - 0.5 ||v - w||_1.

Also the offline trainer (``build_vocabulary``, numpy k-means from
``default_rng(seed)``, so it grows the JAX package's tree), the loader of
the reference's OpenCV-YAML dump (``load_dbow2_yaml``) and of the npz
files the vocabulary builder writes (``load_npz_vocabulary``), and the
keyframe database ``BowDatabase``.

The vocabulary's tensors live on the card unless the caller asks for the
CPU (device.resolve_device).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device


class Vocabulary(NamedTuple):
    children: torch.Tensor  # [num_nodes, k] int64, -1 padded
    descriptors: torch.Tensor  # [num_nodes, C]
    weights: torch.Tensor  # [num_nodes] word weight (0 for inner nodes)
    word_ids: torch.Tensor  # [num_nodes] int64 (-1 for inner nodes)
    num_words: int
    levels: int

    @property
    def branching(self) -> int:
        return self.children.shape[1]

    def to(self, device) -> "Vocabulary":
        return self._replace(children=self.children.to(device), descriptors=self.descriptors.to(device),
                             weights=self.weights.to(device), word_ids=self.word_ids.to(device))


def vocabulary_from_arrays(children, descriptors, weights, word_ids, num_words: int, levels: int,
                           device=None) -> Vocabulary:
    """A Vocabulary from numpy arrays (int ids, float32 descriptors and
    weights)."""
    dev = resolve_device(device)
    t = lambda a, dt: torch.as_tensor(np.array(a), dtype=dt, device=dev)  # noqa: E731
    return Vocabulary(
        children=t(children, torch.int64), descriptors=t(descriptors, torch.float32),
        weights=t(weights, torch.float32), word_ids=t(word_ids, torch.int64),
        num_words=int(num_words), levels=int(levels),
    )


def _descend(voc: Vocabulary, feats: torch.Tensor) -> torch.Tensor:
    """The node each feature [N, C] ends on [N]. Ties go to the first
    child, as argmin does in both packages."""
    node = torch.zeros(feats.shape[0], dtype=torch.int64, device=feats.device)
    big = torch.tensor(1e30, dtype=feats.dtype, device=feats.device)
    for _ in range(voc.levels):
        ch = voc.children[node]  # [N, k]
        valid = ch >= 0
        ch_safe = torch.clamp(ch, min=0)
        dist = torch.sum((feats[:, None, :] - voc.descriptors[ch_safe]) ** 2, dim=-1)
        dist = torch.where(valid, dist, big)
        best = torch.gather(ch_safe, 1, torch.argmin(dist, dim=-1, keepdim=True))[:, 0]
        # nodes with no children stay put (ragged trees)
        node = torch.where(valid.any(dim=-1), best, node)
    return node


def descend_to_words(voc: Vocabulary, features) -> torch.Tensor:
    """Per-feature word id [N] after the hierarchical descent (-1 only if a
    feature dead-ends on a childless inner node)."""
    return voc.word_ids[_descend(voc, torch.as_tensor(features, device=voc.descriptors.device))]


def transform(voc: Vocabulary, features: torch.Tensor) -> torch.Tensor:
    """features [N, C] -> L1-normalised dense BoW vector [num_words]. All
    the features of a word add that word's one weight, so the order of the
    scatter-add (atomics on the card) does not change the sum."""
    node = _descend(voc, features)
    wid = voc.word_ids[node]
    w = torch.where(wid >= 0, voc.weights[node], torch.zeros((), dtype=features.dtype, device=features.device))
    bow = torch.zeros(voc.num_words, dtype=features.dtype, device=features.device)
    bow.index_add_(0, torch.clamp(wid, min=0), w)
    return bow / torch.clamp(torch.sum(torch.abs(bow)), min=1e-12)


def score_l1(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score of L1-normalised vectors, batched over w's leading
    dims."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v - w), dim=-1)


# ---------------------------------------------------------------------------
# training (the voc_builder tool)


def _kmeans(features: np.ndarray, k: int, iters: int, rng) -> tuple:
    """Plain k-means (numpy, offline tooling). Returns (centers, assign)."""
    n = len(features)
    if n <= k:
        return features.copy(), np.arange(n)
    centers = features[rng.choice(n, k, replace=False)]
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = ((features[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(k):
            sel = assign == j
            if sel.any():
                centers[j] = features[sel].mean(0)
    return centers, assign


def build_vocabulary(features: np.ndarray, k: int = 10, levels: int = 3, kmeans_iters: int = 8,
                     seed: int = 0, doc_ids: np.ndarray | None = None, device=None) -> Vocabulary:
    """Hierarchical k-means vocabulary with TF-IDF word weights (DBoW2's
    create + setNodeWeights): idf = log(N_docs / docs containing the word)
    from the per-feature document ids ``doc_ids``; uniform weights without
    them."""
    rng = np.random.default_rng(seed)
    c = features.shape[1]
    nodes_desc = [np.zeros(c, features.dtype)]  # root
    children: list = [[]]
    frontier = [(0, features)]  # breadth first
    for _ in range(levels):
        next_frontier = []
        for node_id, feats in frontier:
            if len(feats) == 0:
                continue
            centers, assign = _kmeans(feats, k, kmeans_iters, rng)
            for j in range(len(centers)):
                cid = len(nodes_desc)
                nodes_desc.append(centers[j])
                children.append([])
                children[node_id].append(cid)
                next_frontier.append((cid, feats[assign == j]))
        frontier = next_frontier

    num_nodes = len(nodes_desc)
    word_ids = np.full(num_nodes, -1, np.int64)
    leaves = [i for i in range(num_nodes) if not children[i] and i != 0]
    for wid, nid in enumerate(leaves):
        word_ids[nid] = wid
    num_words = len(leaves)
    ch_arr = np.full((num_nodes, k), -1, np.int64)
    for i, ch in enumerate(children):
        ch_arr[i, : len(ch)] = ch
    descriptors = np.stack(nodes_desc)

    weights = np.zeros(num_nodes, np.float32)
    if doc_ids is not None:
        uniform = vocabulary_from_arrays(ch_arr, descriptors, np.ones(num_nodes), word_ids, num_words,
                                         levels, device=device)
        wid_per_feat = descend_to_words(uniform, torch.as_tensor(features)).cpu().numpy()
        doc_ids = np.asarray(doc_ids)
        docs = np.unique(doc_ids)
        n_with = np.zeros(num_words, np.int64)
        for d in docs:
            wids = np.unique(wid_per_feat[doc_ids == d])
            n_with[wids[wids >= 0]] += 1
        idf = np.zeros(num_words, np.float32)
        present = n_with > 0
        idf[present] = np.log(len(docs) / n_with[present].astype(np.float64))
        leaf_nodes = np.flatnonzero(word_ids >= 0)
        weights[leaf_nodes] = idf[word_ids[leaf_nodes]]
        if not np.any(weights > 0):
            # degenerate corpus (every word in every doc): keep uniform
            weights[word_ids >= 0] = 1.0
    else:
        weights[word_ids >= 0] = 1.0
    return vocabulary_from_arrays(ch_arr, descriptors, weights, word_ids, num_words, levels,
                                  device=device)


def load_dbow2_yaml(path: str, device=None) -> Vocabulary:
    """The reference's OpenCV-YAML vocabulary (bow_voc.yml(.gz)): nodes
    with nodeId / parentId / weight / descriptor, words with wordId /
    nodeId."""
    import gzip
    import re

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", errors="ignore") as f:
        text = f.read()
    k = int(re.search(r"\bk:\s*(\d+)", text).group(1))
    levels = int(re.search(r"\bL:\s*(\d+)", text).group(1))
    # flow maps such as  - { nodeId:1, parentId:0, weight:0., descriptor:"-0.39 ..." }
    # (the quoted descriptor may span lines)
    node_re = re.compile(
        r"nodeId:\s*(\d+),\s*parentId:\s*(\d+),\s*weight:\s*"
        r"([\d.eE+-]+),\s*descriptor:\s*\"([^\"]*)\"",
        re.S,
    )
    nodes = node_re.findall(text)
    words = re.compile(r"wordId:\s*(\d+),\s*nodeId:\s*(\d+)", re.S).findall(text)

    num_nodes = len(nodes) + 1
    c = len(nodes[0][3].split()) if nodes else 1
    desc = np.zeros((num_nodes, c), np.float32)
    weights = np.zeros(num_nodes, np.float32)
    children_map: dict = {i: [] for i in range(num_nodes)}
    for nid_s, pid_s, w_s, d_s in nodes:
        nid = int(nid_s)
        desc[nid] = np.array(d_s.split(), dtype=np.float64)
        weights[nid] = float(w_s)
        children_map[int(pid_s)].append(nid)
    word_ids = np.full(num_nodes, -1, np.int64)
    for wid_s, nid_s in words:
        word_ids[int(nid_s)] = int(wid_s)
    weights[word_ids < 0] = 0.0  # inner nodes carry no word weight
    ch_arr = np.full((num_nodes, k), -1, np.int64)
    for i, ch in children_map.items():
        ch_arr[i, : min(len(ch), k)] = ch[:k]
    return vocabulary_from_arrays(ch_arr, desc, weights, word_ids, len(words), levels, device=device)


def load_npz_vocabulary(path: str, device=None) -> Vocabulary:
    """A vocabulary saved by the vocabulary builder (npz with children,
    descriptors, weights, word_ids, num_words, levels), such as
    eval_artifacts/bow_voc.npz."""
    d = np.load(path)
    return vocabulary_from_arrays(d["children"], d["descriptors"], d["weights"], d["word_ids"],
                                  int(d["num_words"]), int(d["levels"]), device=device)


# the score of a row the database does not hold (at or beyond its count)
EMPTY_SCORE = -1e30


class BowDatabase:
    """The keyframes' BoW vectors [capacity, num_words], allocated once on
    the vocabulary's device and written row by row in place."""

    def __init__(self, voc: Vocabulary, capacity: int, dtype=torch.float32):
        self.voc = voc
        self.capacity = capacity
        self.vectors = torch.zeros((capacity, voc.num_words), dtype=dtype, device=voc.descriptors.device)
        self.count = 0

    def add(self, features: torch.Tensor) -> torch.Tensor:
        """features [N, C] -> the BoW vector, written to row ``count``.

        The row is written THEN ``count`` moves, and ``query`` reads
        ``count`` before it scores, so a concurrent query never scores a
        row ``count`` does not cover yet (the loop thread queries while the
        frontend adds; both issue their kernels on the default stream, so
        the row's write runs before any later query's scoring)."""
        bow = transform(self.voc, features)
        self.vectors[self.count] = bow
        self.count += 1
        return bow

    def query(self, bow: torch.Tensor, top_k: int, conn_ids=()):
        """The top-k most similar rows, scored and selected over the whole
        capacity on the device: (scores descending, ids, the best score
        over ``conn_ids`` clamped at 0) as host values in one read. Rows at
        or beyond ``count`` score EMPTY_SCORE, so a caller's descending scan
        stops there."""
        count = self.count  # before the vectors (see add)
        dev = self.vectors.device
        top_k = min(top_k, self.capacity)
        masked = torch.where(torch.arange(self.capacity, device=dev) < count,
                             score_l1(bow, self.vectors),
                             torch.full((), EMPTY_SCORE, dtype=self.vectors.dtype, device=dev))
        vals, ids = torch.topk(masked, top_k)
        conn_mask = np.zeros(self.capacity, bool)
        conn_mask[list(conn_ids)] = True
        conn = torch.as_tensor(conn_mask, device=dev)
        ref_max = torch.clamp(torch.max(torch.where(conn, masked, torch.full_like(masked, -float("inf")))),
                              min=0.0)
        host = torch.cat([vals.double(), ids.double(), ref_max.double()[None]]).cpu().numpy()
        return host[:top_k].astype(np.float32), host[top_k : 2 * top_k].astype(np.int64), float(host[-1])

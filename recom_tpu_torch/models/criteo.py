# Port copy of recom_tpu/models/criteo.py: only the package name in imports differs.
"""Criteo-style DLRM: 26 categorical + 13 dense, dot-interaction tower.

BASELINE.json config 2.  Categorical features are integer ids hashed into
per-feature vocab buckets (the standard Criteo preprocessing); dense features
feed a bottom MLP whose output joins the 26 embedding vectors in a pairwise
dot-product interaction, then a top MLP (DLRM, Naumov et al. 2019).
"""

from __future__ import annotations

from typing import Sequence

from recom_tpu_torch.ir.spec import (
    Combiner,
    FeatureColumn,
    FeatureKind,
    FeatureSource,
    HashBucket,
    LookupSpec,
    ModelSpec,
    TableSpec,
    TowerSpec,
)

# Capped per-feature vocab sizes (Criteo Kaggle cardinalities, capped at 1M)
CRITEO_VOCABS = (
    1_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
    1_000_000, 1_000_000, 1_000_000, 10, 2_209, 10_667, 155, 4,
    976, 14, 1_000_000, 1_000_000, 1_000_000, 290_792, 10_997, 91, 35,
)


def make_criteo_dlrm(
    embedding_dim: int = 64,
    bottom_mlp: Sequence[int] = (512, 256, 64),
    top_mlp: Sequence[int] = (512, 256, 1),
    vocabs: Sequence[int] = CRITEO_VOCABS,
    seed: int = 0,
) -> ModelSpec:
    assert bottom_mlp[-1] == embedding_dim, "DLRM: bottom MLP must end at dim"
    tables = {}
    columns = []
    for i, vocab in enumerate(vocabs):
        t = f"emb_c{i}"
        tables[t] = TableSpec(t, int(vocab), embedding_dim, init_seed=seed)
        columns.append(
            FeatureColumn(
                f"cat{i}",
                FeatureSource(f"cat{i}", FeatureKind.DENSE_INT),
                (HashBucket(int(vocab)),),
                LookupSpec(t, Combiner.SUM),
            )
        )
    for i in range(13):
        columns.append(
            FeatureColumn(
                f"int{i}", FeatureSource(f"int{i}", FeatureKind.DENSE_FLOAT)
            )
        )
    tower = TowerSpec(
        arch="dlrm_dot",
        bottom_mlp=tuple(bottom_mlp),
        top_mlp=tuple(top_mlp),
        final_activation="sigmoid",
        init_seed=seed,
    )
    return ModelSpec("criteo_dlrm", tables, columns, tower)


def read_criteo_tsv(path, batch_size: int, max_batches=None, log_dense=True):
    """Stream batches from a Criteo-format TSV file.

    Format (Kaggle / Terabyte display-ads logs): per line, tab-separated
    ``label, I1..I13 (ints, may be empty), C1..C26 (hex strings, may be
    empty)``.  Yields (batch_dict, labels) pairs matching
    :func:`make_criteo_dlrm`'s feature names:

      * ``int{i}``:  float32; empty -> 0; log(1+x) transform when
        ``log_dense`` (standard DLRM preprocessing; negatives clamp to 0)
      * ``cat{i}``:  int64 id from the hex token (empty -> 0); the model's
        HashBucket transform maps it into the per-feature vocab

    Parsing runs in the native C++ chunk parser when available
    (native/host_ops.cc rt_parse_criteo: one call per 4MB chunk instead
    of a Python loop per line — the data-ingestion hot path for DLRM
    training), with this Python line loop as the fallback; the two are
    equivalence-tested (tests/test_engine.py).
    """
    import numpy as np

    from recom_tpu_torch.native import ops as native_ops

    def emit(labels, dense, cats):
        batch = {}
        for i in range(13):
            col = dense[i]
            if log_dense:
                col = np.log1p(np.maximum(col, 0.0))
            batch[f"int{i}"] = np.ascontiguousarray(col)
        for i in range(26):
            batch[f"cat{i}"] = np.ascontiguousarray(cats[i])
        return batch, np.ascontiguousarray(labels)

    if native_ops.parse_criteo(b"", 0) is not None:
        def parsed_chunks():
            carry = b""
            with open(path, "rb") as f:
                while True:
                    chunk = f.read(1 << 22)
                    if not chunk:
                        if carry:          # flush final unterminated line
                            yield native_ops.parse_criteo(carry + b"\n")
                        return
                    data = carry + chunk
                    res = native_ops.parse_criteo(data)
                    carry = data[res[4]:]
                    if res[3]:
                        yield res

        ls, ds, cs, have, n_batches = [], [], [], 0, 0
        for l, d, c, n, _ in parsed_chunks():
            ls.append(l)
            ds.append(d)
            cs.append(c)
            have += n
            while have >= batch_size:
                L = np.concatenate(ls)
                D = np.concatenate(ds, axis=1)
                C = np.concatenate(cs, axis=1)
                yield emit(L[:batch_size], D[:, :batch_size],
                           C[:, :batch_size])
                ls = [L[batch_size:]]
                ds = [D[:, batch_size:]]
                cs = [C[:, batch_size:]]
                have -= batch_size
                n_batches += 1
                if max_batches is not None and n_batches >= max_batches:
                    return
        if have:
            yield emit(np.concatenate(ls), np.concatenate(ds, axis=1),
                       np.concatenate(cs, axis=1))
        return

    def flush(rows):
        n = len(rows)
        labels = np.asarray([r[0] for r in rows], np.float32)
        batch = {}
        for i in range(13):
            col = np.asarray([r[1][i] for r in rows], np.float32)
            if log_dense:
                col = np.log1p(np.maximum(col, 0.0))
            batch[f"int{i}"] = col
        for i in range(26):
            batch[f"cat{i}"] = np.asarray(
                [r[2][i] for r in rows], np.int64
            )
        return batch, labels

    rows = []
    n_batches = 0
    with open(path, "r") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 40:
                parts = parts + [""] * (40 - len(parts))
            label = int(parts[0] or 0)
            dense = [float(p) if p else 0.0 for p in parts[1:14]]
            cats = [int(p, 16) if p else 0 for p in parts[14:40]]
            rows.append((label, dense, cats))
            if len(rows) == batch_size:
                yield flush(rows)
                rows = []
                n_batches += 1
                if max_batches is not None and n_batches >= max_batches:
                    return
    if rows:
        yield flush(rows)

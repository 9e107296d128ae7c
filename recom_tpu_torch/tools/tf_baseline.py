# Port copy of recom_tpu/tools/tf_baseline.py: only the package name in imports differs,
# and TF is kept off the card by tf.config instead of CUDA_VISIBLE_DEVICES, which
# would hide the card from torch in the same process.
"""Real TF-CPU baseline for a ModelSpec — the system the reference
compares against (README.md:29-31 reports 6.61x over TF-CPU).

Builds the same model as a TensorFlow graph out of the standard ops the
reference's feature columns lower to (Bucketize, StringToHashBucketFast,
StringSplit, safe_embedding_lookup_sparse, ConcatV2, dense matmuls) and
wraps it in tf.function — i.e., the unoptimized thousands-of-small-ops
execution RECom was built to fix, as a genuine measurable baseline rather
than a NumPy stand-in.

Covered column shapes (everything in models E/F/micro/criteo):
  DENSE_FLOAT + [Bucketize]           -> Bucketize + embedding lookup
  DENSE_INT   + [HashBucket]          -> as_string + to_hash_bucket_fast
  STRING      + [HashBucket]          -> to_hash_bucket_fast
  STRING_LIST (delimited) + [HashBucket] -> StringSplit + hash + sparse pool
  INT_LIST + [NumToId]                -> identity sparse ids + sparse pool
  dense passthrough columns           -> tower input
Weighted lookups (LookupSpec.weight_field) feed the aligned ragged score
list (or the flat [B] scalar-weight form) as sparse_weights;
Combiner.SOFTMAX applies tf.sparse.softmax to the scores first (the
reference's SparseSoftmax + SequenceMask pattern,
post_lookup_optimizer.cc:311-478).  NumToId default_id maps out-of-range
identity ids; PostPool chains (reduce/affine/softmax/mul_column/matmul)
are computed in TF ops, with hidden (in_concat=False) operand columns
pooled for mul_column.
Unsupported transforms/activations raise (the bench falls back to the
oracle baseline) — the ground truth must match or fail loudly, never
silently compute different math.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

os.environ.setdefault("TF_ENABLE_ONEDNN_OPTS", "0")
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

from recom_tpu_torch.ir.spec import (
    Bucketize,
    Combiner,
    FeatureKind,
    HashBucket,
    ModelSpec,
    NumToId,
)

_COMB = {Combiner.SUM: "sum", Combiner.MEAN: "mean", Combiner.SQRTN: "sqrtn"}


def build_tf_baseline(model: ModelSpec, np_params: Dict):
    """Returns (fn, make_feed): ``fn`` is a tf.function mapping a feed dict
    of tf tensors to the model output; ``make_feed`` converts a raw numpy
    batch into that feed."""
    import tensorflow as tf

    try:    # the TF-CPU baseline: keep TF off any card it can see
        tf.config.set_visible_devices([], "GPU")
    except (RuntimeError, ValueError):
        pass    # TF's devices are already initialized (or it has no GPU)

    tables = {
        name: tf.constant(np.asarray(arr, np.float32))
        for name, arr in np_params["tables"].items()
    }
    tower_params = {
        key: [
            (tf.constant(l["w"]), tf.constant(l["b"])) for l in layers
        ]
        for key, layers in np_params["tower"].items()
    }

    dense_fields = [c.source.field for c in model.dense_columns]
    emb_cols = [c for c in model.embedding_columns if c.in_concat]
    all_emb_cols = list(model.embedding_columns)  # incl. hidden operands

    def scalar_sparse(col, ids64, valid):
        """[B] ids + validity mask -> SparseTensor [B, 1] (invalid entries
        dropped: their rows become empty -> zeros, TF ignore_value
        semantics); used for weighted scalar columns where the dense
        embedding_lookup fast path cannot carry sparse_weights."""
        n = tf.shape(ids64, out_type=tf.int64)[0]
        rows = tf.boolean_mask(tf.range(n), valid)
        sp = tf.sparse.SparseTensor(
            tf.stack([rows, tf.zeros_like(rows)], axis=1),
            tf.boolean_mask(ids64, valid),
            tf.stack([n, tf.constant(1, tf.int64)]),
        )
        return sp, valid

    def raw_pooled(col, feed):
        """RAW pooled [B, d] for any embedding column (pre-post)."""
        kind = col.source.kind
        t = tables[col.lookup.table]
        comb = _COMB.get(col.lookup.combiner)
        wf = col.lookup.weight_field
        if kind == FeatureKind.DENSE_FLOAT:
            (bz,) = col.transforms
            assert isinstance(bz, Bucketize), "tf baseline: Bucketize only"
            ids = tf.raw_ops.Bucketize(
                input=feed[col.source.field],
                boundaries=[float(b) for b in bz.boundaries],
            )
            ids = tf.cast(ids, tf.int64)
            if wf is None:
                return tf.nn.embedding_lookup(t, ids)
            sp, valid = scalar_sparse(col, ids, tf.ones_like(ids) > 0)
            return sparse_pool(
                col, sp, t, comb,
                weight_values=tf.boolean_mask(feed[wf], valid),
            )
        if kind in (FeatureKind.DENSE_INT, FeatureKind.STRING):
            (hb,) = col.transforms
            assert isinstance(hb, HashBucket)
            x = feed[col.source.field]
            if kind == FeatureKind.DENSE_INT:
                valid = tf.not_equal(x, -1)     # TF ignore_value semantics
                ids = tf.strings.to_hash_bucket_fast(
                    tf.strings.as_string(x), hb.num_buckets
                )
            else:
                valid = tf.ones([tf.shape(x)[0]], tf.bool)
                ids = tf.strings.to_hash_bucket_fast(x, hb.num_buckets)
            if wf is None:
                emb = tf.nn.embedding_lookup(t, ids)
                return tf.where(valid[:, None], emb, tf.zeros_like(emb))
            sp, valid = scalar_sparse(col, ids, valid)
            return sparse_pool(
                col, sp, t, comb,
                weight_values=tf.boolean_mask(feed[wf], valid),
            )
        if kind in (FeatureKind.STRING_LIST, FeatureKind.INT_LIST):
            if kind == FeatureKind.STRING_LIST:
                (hb,) = col.transforms
                assert isinstance(hb, HashBucket)
                x = feed[col.source.field]
                sp = (
                    x.to_sparse()   # pre-split ragged rows
                    if isinstance(x, tf.RaggedTensor)
                    else tf.strings.split(
                        x, sep=col.source.delimiter
                    ).to_sparse()
                )
                ids = tf.sparse.SparseTensor(
                    sp.indices,
                    tf.strings.to_hash_bucket_fast(sp.values, hb.num_buckets),
                    sp.dense_shape,
                )
            else:
                # identity ids (categorical_column_with_identity)
                (nti,) = col.transforms
                assert isinstance(nti, NumToId)
                ids = feed[col.source.field].to_sparse()
                if nti.default_id is not None:
                    # TF identity-column default_value: out-of-range ids
                    # map to the default (the oracle does the same,
                    # oracle/reference.py NumToId branch)
                    v = ids.values
                    v = tf.where(
                        (v < 0) | (v >= nti.num_ids),
                        tf.constant(nti.default_id, v.dtype), v,
                    )
                    ids = tf.sparse.SparseTensor(
                        ids.indices, v, ids.dense_shape
                    )
            wvals = None
            if wf is not None:
                # aligned ragged score list: the split's sparse indices
                # and the ragged flat values are both row-major
                wvals = tf.cast(feed[wf].flat_values, tf.float32)
            return sparse_pool(col, ids, t, comb, weight_values=wvals)
        raise NotImplementedError(f"tf baseline: column kind {kind}")

    def sparse_pool(col, ids, t, comb, weight_values=None):
        """safe_embedding_lookup_sparse with the model's weighting scheme
        (``weight_values`` aligned with ``ids.values``)."""
        weights = None
        if weight_values is not None:
            weights = tf.sparse.SparseTensor(
                ids.indices, weight_values, ids.dense_shape
            )
        if col.lookup.combiner == Combiner.SOFTMAX:
            # the reference's SparseSoftmax + SequenceMask pattern: rowwise
            # softmax of the scores over the valid positions, then a
            # weighted sum.  No score feed -> uniform scores (softmax ->
            # 1/n), matching the engine's ones default.
            if weights is None:
                weights = tf.sparse.SparseTensor(
                    ids.indices,
                    tf.ones_like(tf.cast(ids.values, tf.float32)),
                    ids.dense_shape,
                )
            return tf.nn.safe_embedding_lookup_sparse(
                t, ids, sparse_weights=tf.sparse.softmax(weights),
                combiner="sum", default_id=None,
            )
        return tf.nn.safe_embedding_lookup_sparse(
            t, ids, sparse_weights=weights, combiner=comb, default_id=None
        )

    def apply_post(col, x, raw_map):
        """PostPool chain in TF ops (mul_column operands are other
        columns' RAW pooled outputs, matching the engine contract)."""
        for p in col.post:
            if p.op == "reduce_sum":
                x = tf.reduce_sum(x, axis=1, keepdims=True)
            elif p.op == "reduce_mean":
                x = tf.reduce_mean(x, axis=1, keepdims=True)
            elif p.op == "softmax":
                x = tf.nn.softmax(x, axis=1)
            elif p.op == "mul_column":
                x = x * raw_map[p.other]
            elif p.op == "matmul":
                x = tf.matmul(
                    x, tf.constant(np.asarray(p.weight, np.float32))
                )
            elif p.op == "affine":
                if p.scale is not None:
                    x = x * tf.constant(np.asarray(p.scale, np.float32))
                if p.bias is not None:
                    x = x + tf.constant(np.asarray(p.bias, np.float32))
            else:
                raise NotImplementedError(f"tf baseline post op {p.op!r}")
        return x

    def act_fn(name):
        if name == "relu":
            return tf.nn.relu
        if name == "sigmoid":
            return tf.sigmoid
        if name in (None, "none"):
            return lambda x: x
        # silently skipping an activation would make the "ground truth"
        # compute different math than the engine under comparison
        raise NotImplementedError(f"tf baseline activation {name!r}")

    def mlp(layers, x, act, final_act):
        hidden, final = act_fn(act), act_fn(final_act)
        for i, (w, b) in enumerate(layers):
            x = tf.matmul(x, w) + b
            x = final(x) if i == len(layers) - 1 else hidden(x)
        return x

    tower = model.tower

    def forward(feed):
        raw_map = {c.name: raw_pooled(c, feed) for c in all_emb_cols}
        embs = [apply_post(c, raw_map[c.name], raw_map) for c in emb_cols]
        dense = (
            tf.concat(
                [
                    tf.reshape(feed[c.source.field],
                               [-1, c.source.width])
                    for c in model.dense_columns
                ],
                axis=1,
            )
            if dense_fields
            else tf.zeros([tf.shape(embs[0])[0], 0])
        )
        if tower.arch == "mlp":
            front = dense
            if tower.bottom_mlp and dense_fields:
                front = mlp(tower_params["bottom"], dense,
                            tower.activation, tower.activation)
            x = tf.concat([front] + embs, axis=1)
            return mlp(tower_params["top"], x, tower.activation,
                       tower.final_activation)
        if tower.arch == "dlrm_dot":
            bottom = mlp(tower_params["bottom"], dense,
                         tower.activation, tower.activation)
            vecs = tf.stack([bottom] + embs, axis=1)
            gram = tf.matmul(vecs, vecs, transpose_b=True)
            n = len(embs) + 1
            iu = np.triu_indices(n, k=1)
            flat = tf.reshape(gram, [-1, n * n])
            inter = tf.gather(flat, iu[0] * n + iu[1], axis=1)
            x = tf.concat([bottom, inter], axis=1)
            return mlp(tower_params["top"], x, tower.activation,
                       tower.final_activation)
        raise NotImplementedError(tower.arch)

    fn = tf.function(forward)

    def make_feed(batch: Dict):
        import tensorflow as tf

        def _item_counts(rows, delimiter):
            """Per-row item counts of an id feed, or None when they cannot
            be derived (whitespace-split wire strings)."""
            counts = []
            for r in rows:
                if isinstance(r, (bytes, np.bytes_)):
                    r = r.decode()
                if isinstance(r, str):
                    if delimiter is None:
                        return None
                    counts.append(r.count(delimiter) + 1 if r else 0)
                elif hasattr(r, "__len__"):
                    counts.append(len(r))
                else:
                    return None     # scalar id feed: nothing to align
            return counts

        feed = {}
        for col in model.columns:
            f = col.source.field
            wf = col.lookup.weight_field if col.lookup else None
            if wf is not None and wf not in feed and wf in batch:
                rows = batch[wf]
                first = rows[0] if len(rows) else None
                if first is not None and not isinstance(
                    first, (list, tuple, np.ndarray)
                ):
                    # scalar weights (one float per example) for a
                    # single-value column: flat [B] feed
                    feed[wf] = tf.constant(
                        np.asarray(rows, np.float32)
                    )
                else:
                    # aligned ragged score list (FLOAT_LIST weight plane).
                    # Validate PER-ROW lengths against the id feed —
                    # sparse_pool pairs ids.indices with the flattened
                    # scores, so equal totals with mismatched rows would
                    # silently misassign scores across rows (the oracle's
                    # materialize_source raises on this; the ground-truth
                    # baseline must too).
                    wl = [len(r) for r in rows]
                    il = _item_counts(batch.get(f, []),
                                      col.source.delimiter)
                    if il is not None and il != wl:
                        bad = next(
                            i for i, (a, b) in enumerate(zip(il, wl))
                            if a != b
                        )
                        raise ValueError(
                            f"weight field {wf!r} row {bad} has {wl[bad]} "
                            f"scores for {il[bad]} ids in {f!r}"
                        )
                    feed[wf] = tf.ragged.constant(
                        [list(map(float, r)) for r in rows],
                        dtype=tf.float32, row_splits_dtype=tf.int64,
                    )
            if f in feed or f not in batch:
                continue
            kind = col.source.kind
            if kind == FeatureKind.DENSE_FLOAT:
                feed[f] = tf.constant(
                    np.asarray(batch[f], np.float32)
                )
            elif kind == FeatureKind.DENSE_INT:
                feed[f] = tf.constant(np.asarray(batch[f], np.int64))
            elif kind == FeatureKind.INT_LIST:
                feed[f] = tf.ragged.constant(
                    [list(map(int, r)) for r in batch[f]],
                    dtype=tf.int64, row_splits_dtype=tf.int64,
                )
            elif kind in (FeatureKind.STRING, FeatureKind.STRING_LIST):
                rows = batch[f]
                if kind == FeatureKind.STRING_LIST and (
                    len(rows) and isinstance(rows[0], (list, np.ndarray))
                ):
                    # pre-split ragged rows (no delimiter wire format)
                    feed[f] = tf.ragged.constant(
                        [
                            [
                                s.decode() if isinstance(s, bytes) else str(s)
                                for s in r
                            ]
                            for r in rows
                        ],
                        dtype=tf.string, row_splits_dtype=tf.int64,
                    )
                    continue
                arr = np.asarray(rows)
                if arr.dtype.kind == "S":
                    arr = arr.astype("U")
                feed[f] = tf.constant(arr)
            else:
                raise NotImplementedError(f"tf baseline feed: {kind}")
        return feed

    return fn, make_feed

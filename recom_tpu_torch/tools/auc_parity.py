# Port of recom_tpu/tools/auc_parity.py: a copy (the package name in imports
# renamed) but for the engine side, train_engine, on the port's Trainer, and
# main's --device.
"""End-to-end AUC parity: engine training vs real TensorFlow-CPU.

BASELINE.md's quality row demands "end-to-end AUC within run-to-run
variance" — a convergence-quality check, not a throughput one (the
reference validates quality by AE-figure comparison only; we train for
real).  Protocol:

  * ONE synthetic binary-classification model with planted signal (ids
    skew + a dense feature drive the label), identical float32 init on
    both sides (utils/params.init_model_params).
  * Engine side: recom_tpu_torch.train.Trainer (optax's Adam rule),
    on the card unless ``--device cpu``, N steps over a
    deterministic batch stream; AUC on a held-out set.
  * TF side: the SAME math — embedding_lookup + segment mean pool,
    [dense, pooled] concat (our layout), the same MLP tower from the
    same init — trained with tf.keras Adam (identical update rule) on
    the SAME batch stream.
  * Run-to-run variance: the engine trains at ``--runs`` extra data
    orders; parity holds when |engine_auc - tf_auc| <= max(2*sd, 0.01).

  python -m recom_tpu_torch.tools.auc_parity --steps 300 --out AUC_r03.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney AUC with MIDRANKS for ties.  Saturated float32
    sigmoids tie many scores at exactly 0.0/1.0; assigning tied pos/neg
    examples arbitrary distinct ranks (unstable argsort) shifts the rank
    sum by up to the tied mass and corrupts the parity gate — midranks
    are the standard tie treatment (ties count 0.5, per the U statistic).
    All-tied scores then give exactly 0.5 (chance), as they should."""
    scores = np.asarray(scores, np.float64)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    s = scores[order]
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and s[j + 1] == s[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0   # midrank, 1-based
        i = j + 1
    pos = np.asarray(labels) > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float(
        (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    )


VOCAB, DIM = 64, 8


def make_model():
    from recom_tpu_torch.ir.spec import (
        Combiner,
        FeatureColumn,
        FeatureKind,
        FeatureSource,
        LookupSpec,
        ModelSpec,
        NumToId,
        TableSpec,
        TowerSpec,
    )

    tables = {"t": TableSpec("t", VOCAB, DIM)}
    cols = [
        FeatureColumn(
            "ids", FeatureSource("ids", FeatureKind.INT_LIST),
            (NumToId(VOCAB),), LookupSpec("t", Combiner.MEAN),
        ),
        FeatureColumn("d0", FeatureSource("d0", FeatureKind.DENSE_FLOAT)),
    ]
    tower = TowerSpec(arch="mlp", bottom_mlp=(), top_mlp=(16, 1),
                      final_activation="sigmoid")
    return ModelSpec("aucpar", tables, cols, tower)


def make_data(rng, n):
    """Planted rule: label ~ (mean id / vocab) + dense, with noise.  Every
    row carries >=1 id so TF's unsorted_segment_mean never divides by 0."""
    lens = rng.integers(1, 6, n)
    ids = [rng.integers(0, VOCAB, size=int(k)).tolist() for k in lens]
    d0 = rng.standard_normal(n).astype(np.float32)
    signal = np.array([np.mean(r) / (VOCAB - 1) for r in ids]) + 0.3 * d0
    labels = (
        signal + 0.1 * rng.standard_normal(n) > 0.55
    ).astype(np.float32)
    return {"ids": ids, "d0": d0}, labels


def batch_stream(seed, steps, bs):
    rng = np.random.default_rng(seed)
    return [make_data(rng, bs) for _ in range(steps)]


EVAL_N = 8192


def train_engine(model, np_params, stream, eval_batch, eval_labels, lr,
                 device=None):
    """The port's ``Trainer`` with Adam (optax's rule) on ``device`` (the
    card by default)."""
    import copy

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.train import Trainer, adam

    tr = Trainer(
        model,
        EngineConfig(use_pallas=False,
                     # train bucket + the held-out eval batch size
                     batch_buckets=(len(stream[0][1]), EVAL_N)),
        optimizer=adam(lr),
        params=copy.deepcopy(np_params),
        device=device,
    )
    losses = [tr.step(b, l) for b, l in stream]
    scores = np.asarray(tr.engine.predict(eval_batch)["output"])[:, 0]
    return auc(eval_labels, scores), losses


def _flatten_ids(ids):
    vals = np.concatenate([np.asarray(r, np.int64) for r in ids]) % VOCAB
    segs = np.repeat(np.arange(len(ids), dtype=np.int64),
                     [len(r) for r in ids])
    return vals, segs


def train_tf(model, np_params, stream, eval_batch, eval_labels, lr,
             dense_table_grad=True):
    """TF-CPU training with the same math.

    ``dense_table_grad=True`` (the parity arm) converts the table's
    IndexedSlices gradient to dense before Adam.  keras Adam's sparse path
    accumulates the second moment from PER-OCCURRENCE squared slices —
    sum_i g_i^2 over duplicate ids — where dense Adam (and optax) uses the
    square of the summed row gradient (sum_i g_i)^2.  With hot ids the
    sparse v is ~k× smaller, so keras takes larger embedding steps: an
    implementation artifact of IndexedSlices, not different training math.
    Verified: densifying makes the TF loss trajectory match the engine's
    to 1e-6 over every step; the sparse arm is recorded separately."""
    import os

    os.environ.setdefault("TF_ENABLE_ONEDNN_OPTS", "0")
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
    import tensorflow as tf

    table = tf.Variable(np_params["tables"]["t"], name="t")
    (l1, l2) = np_params["tower"]["top"]
    w1 = tf.Variable(l1["w"]); b1 = tf.Variable(l1["b"])
    w2 = tf.Variable(l2["w"]); b2 = tf.Variable(l2["b"])
    variables = [table, w1, b1, w2, b2]
    # epsilon=1e-8 matches optax.adam's default (keras defaults to 1e-7 —
    # a real update-rule difference, not noise)
    opt = tf.keras.optimizers.Adam(learning_rate=lr, epsilon=1e-8)

    sig = [
        tf.TensorSpec([None], tf.int64),   # vals (ragged total varies)
        tf.TensorSpec([None], tf.int64),   # segs
        tf.TensorSpec([None], tf.float32),  # d0
        tf.TensorSpec([], tf.int64),        # n
    ]

    @tf.function(input_signature=sig)
    def forward(vals, segs, d0, n):
        emb = tf.nn.embedding_lookup(table, vals)
        pooled = tf.math.unsorted_segment_mean(emb, segs, n)
        x = tf.concat([tf.reshape(d0, [-1, 1]), pooled], axis=1)
        h = tf.nn.relu(tf.matmul(x, w1) + b1)
        return tf.matmul(h, w2) + b2

    @tf.function(input_signature=sig + [tf.TensorSpec([None], tf.float32)])
    def step(vals, segs, d0, n, labels):
        with tf.GradientTape() as tape:
            logits = forward(vals, segs, d0, n)[:, 0]
            loss = tf.reduce_mean(
                tf.nn.sigmoid_cross_entropy_with_logits(
                    labels=labels, logits=logits
                )
            )
        grads = tape.gradient(loss, variables)
        g0 = grads[0]
        if dense_table_grad and isinstance(g0, tf.IndexedSlices):
            g0 = tf.math.unsorted_segment_sum(
                g0.values, g0.indices, tf.shape(table)[0]
            )
        opt.apply_gradients(zip([g0] + grads[1:], variables))
        return loss

    losses = []
    for b, l in stream:
        vals, segs = _flatten_ids(b["ids"])
        losses.append(float(step(
            tf.constant(vals), tf.constant(segs),
            tf.constant(b["d0"]), tf.constant(len(l), tf.int64),
            tf.constant(l),
        )))
    vals, segs = _flatten_ids(eval_batch["ids"])
    scores = tf.sigmoid(forward(
        tf.constant(vals), tf.constant(segs),
        tf.constant(eval_batch["d0"]),
        tf.constant(len(eval_labels), tf.int64),
    )[:, 0]).numpy()
    return auc(eval_labels, scores), losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--runs", type=int, default=3,
                    help="engine runs at distinct data orders (variance)")
    ap.add_argument("--device", default=None,
                    help="the engine side's device: cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    model = make_model()
    from recom_tpu_torch.utils.params import init_model_params

    np_params = init_model_params(model)
    eval_batch, eval_labels = make_data(np.random.default_rng(999), EVAL_N)
    chance = auc(eval_labels, np.zeros_like(eval_labels))

    engine_aucs = []
    engine_train_s = []
    for run in range(args.runs):
        stream = batch_stream(100 + run, args.steps, args.batch)
        t0 = time.perf_counter()
        a, losses = train_engine(
            model, np_params, stream, eval_batch, eval_labels, args.lr,
            device=args.device,
        )
        engine_aucs.append(a)
        engine_train_s.append(round(time.perf_counter() - t0, 1))
        print(json.dumps({
            "side": "engine", "run": run, "auc": round(a, 4),
            "loss_first": round(losses[0], 4),
            "loss_last": round(losses[-1], 4),
            "train_s": round(time.perf_counter() - t0, 1),
        }))

    stream = batch_stream(100, args.steps, args.batch)
    t0 = time.perf_counter()
    tf_auc, tf_losses = train_tf(
        model, np_params, stream, eval_batch, eval_labels, args.lr
    )
    tf_train_s = time.perf_counter() - t0
    print(json.dumps({
        "side": "tf_cpu", "auc": round(tf_auc, 4),
        "loss_first": round(tf_losses[0], 4),
        "loss_last": round(tf_losses[-1], 4),
        "train_s": round(tf_train_s, 1),
    }))
    # informational arm: keras Adam's native IndexedSlices path (the
    # per-occurrence-squares second moment — see train_tf docstring)
    tf_sparse_auc, _ = train_tf(
        model, np_params, stream, eval_batch, eval_labels, args.lr,
        dense_table_grad=False,
    )
    print(json.dumps({
        "side": "tf_cpu_sparse_adam", "auc": round(tf_sparse_auc, 4),
    }))

    sd = float(np.std(engine_aucs, ddof=1)) if len(engine_aucs) > 1 else 0.0
    gap = abs(float(np.mean(engine_aucs)) - tf_auc)
    tol = max(2 * sd, 0.01)
    doc = {
        "protocol": (
            f"planted-signal DLRM, identical init, Adam lr={args.lr}, "
            f"{args.steps} steps x batch {args.batch}, AUC on held-out 8192"
        ),
        "engine_aucs": [round(a, 4) for a in engine_aucs],
        "engine_auc_mean": round(float(np.mean(engine_aucs)), 4),
        "engine_auc_sd": round(sd, 4),
        "tf_cpu_auc": round(tf_auc, 4),
        "tf_cpu_sparse_adam_auc": round(tf_sparse_auc, 4),
        "sparse_adam_note": (
            "keras Adam's IndexedSlices path builds the table's second "
            "moment from per-occurrence squared slices (sum g_i^2) where "
            "dense Adam/optax square the summed row gradient; the parity "
            "column uses the dense update on both sides — with it the TF "
            "loss trajectory matches the engine's to 1e-6 per step"
        ),
        "auc_gap": round(gap, 4),
        "tolerance": round(tol, 4),
        "parity": bool(gap <= tol),
        "chance_auc": round(chance, 4),
        "engine_train_s": engine_train_s,
        "tf_cpu_train_s": round(tf_train_s, 1),
    }
    out = json.dumps(doc, indent=1)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    if not doc["parity"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

# Port copy of recom_tpu/importers/tf_graph.py: only the package name in imports differs.
"""TF GraphDef importer: frozen TF feature-column graphs -> ModelSpec.

The reference achieves zero-model-change deployment by pattern-matching the
TF graph at session warm-up (ExtractFCNodes finds per-table subgraphs that
converge on the input_layer ConcatV2, graph_info.cc:209-365; Lookup/PreLookup
optimizers then recognize the safe_embedding_lookup_sparse idiom,
lookup_optimizer.cc:62-135).  This importer applies the same extraction ideas
OFFLINE: parse a frozen GraphDef (no TF dependency — protowire.py reads the
protobuf wire format), walk backward from the output concat, and reconstruct
each column as IR plus table weights.

Recognized column idioms (the ones tf.feature_column.input_layer emits for
the reference's benchmark models, examples/python/dlrm.py:56-137):

  * numeric_column -> bucketized_column -> embedding_column
        Placeholder(f32) -> Bucketize(boundaries=...) -> lookup(mean/sum)
  * categorical_column_with_hash_bucket (string or int) -> embedding_column
        Placeholder -> [AsString] -> StringToHashBucketFast(num_buckets)
  * categorical_column_with_vocabulary_list [num_oov_buckets/default_value]
        HashTableV2 + LookupTableFindV2 (+ OOV StringToHashBucketFast)
        -> VocabLookup transform (keys/values read from the frozen
        Import/Initialize op)
  * weighted_categorical_column: the embedding_lookup_sparse weighted
        expansion (Unique + Gather + Mul + SegmentSum [+ DivNoNan]) ->
        LookupSpec.weight_field
  * delimited sparse strings:  StringSplit -> StringToHashBucketFast
        (and the int-list idiom: StringSplit -> StringToNumber(int))
  * categorical_column_with_identity [default_value] -> NumToId /
        SelectRange (the where(out_of_range, fill(default), v) patch-up)
  * indicator_column -> identity-table embedding with the SUM combiner
  * shared_embedding_columns -> multiple columns on one TableSpec
  * crossed_column hashed (SparseCross[V2/Hashed]) -> CrossHash
  * dense passthrough numeric features (incl. numeric_column(shape=(k,)))
  * post-lookup tails: Sum/Mean over the embedding dim, Softmax, frozen
        MatMul projections, const affine, pooled-Mul slots -> PostPool
  * anything else elementwise-with-const on a VALUE path compiles into a
        bounded HostEvalChain (the run-anything host fallback)
  * the frozen dense tower: MatMul/BiasAdd/activation chains after the
        concat import into TowerSpec + weights (import_params overlays
        them), with first-matmul rows permuted from TF's concat-slot
        order to the engine layout

Unrecognized chains raise by default (strict=True) — the reference's
contract is leave-the-graph-unchanged on match failure, and importing with
changed semantics would be worse than failing; strict=False opts into the
warned identity-ids degradation.  Tables are read from frozen Consts, or
from a TF checkpoint bundle via ``checkpoint=`` (load_checkpoint_tables)
when the graph still carries live VariableV2 nodes.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from recom_tpu_torch.importers import protowire as pw
from recom_tpu_torch.ir.spec import (
    Bucketize,
    Combiner,
    CrossHash,
    FeatureColumn,
    FeatureKind,
    FeatureSource,
    HashBucket,
    HostEvalChain,
    LookupSpec,
    ModelSpec,
    TableSpec,
    TowerSpec,
)


# HostEvalChain step op -> TF op names it absorbs.  Residue may allow
# ONLY these (per actual chain content): a blanket MatchExpr whitelist
# would let strict mode silently drop arithmetic on value paths the
# chain did NOT absorb (e.g. a Floor on an un-imported weight feed).
_STEP_TF_OPS = {
    "mul": ("Mul",), "add": ("Add", "AddV2"),
    "sub": ("Sub",), "rsub": ("Sub",),
    "div": ("Div", "RealDiv"), "rdiv": ("Div", "RealDiv"),
    "floordiv": ("FloorDiv",), "mod": ("FloorMod",),
    "minimum": ("Minimum",), "maximum": ("Maximum",),
    "floor": ("Floor",), "ceil": ("Ceil",), "round": ("Round",),
    "cast": ("Cast",),
}


def _hosteval_ops(transforms) -> frozenset:
    """TF op names absorbed by the chain's HostEvalChain steps."""
    out: set = set()
    for t in transforms:
        if isinstance(t, HostEvalChain):
            for op, _, _ in t.steps:
                out.update(_STEP_TF_OPS.get(op, ()))
    return frozenset(out)

DT_FLOAT, DT_DOUBLE, DT_INT32, DT_STRING, DT_INT64 = 1, 2, 3, 7, 9


def _fresh_name(base: str, taken) -> str:
    """First of base, base__2, base__3, ... not in ``taken`` (two columns
    fed by one raw feature need distinct column names)."""
    name, k = base, 2
    while name in taken:
        name = f"{base}__{k}"
        k += 1
    return name


class Node:
    __slots__ = ("name", "op", "inputs", "attrs")

    def __init__(self, name, op, inputs, attrs):
        self.name = name
        self.op = op
        self.inputs = inputs        # names, possibly with :port / ^control
        self.attrs = attrs          # name -> raw AttrValue bytes

    def attr(self, key: str) -> Optional[bytes]:
        return self.attrs.get(key)


def _parse_attr_entries(buf: bytes) -> Dict[str, bytes]:
    out = {}
    # attr map entry: key=1 (string), value=2 (AttrValue)
    d = pw.fields_dict(buf)
    key = d.get(1, [b""])[0].decode()
    out[key] = d.get(2, [b""])[0]
    return out


def parse_graphdef(data: bytes) -> List[Node]:
    nodes = []
    for field, _, val in pw.iter_fields(data):
        if field != 1:       # GraphDef.node
            continue
        d = pw.fields_dict(val)
        name = d.get(1, [b""])[0].decode()
        op = d.get(2, [b""])[0].decode()
        inputs = [x.decode() for x in d.get(3, [])]
        attrs: Dict[str, bytes] = {}
        for entry in d.get(5, []):
            attrs.update(_parse_attr_entries(entry))
        nodes.append(Node(name, op, inputs, attrs))
    return nodes


# ------------------------ AttrValue helpers --------------------------------


def attr_int(raw: Optional[bytes]) -> Optional[int]:
    if raw is None:
        return None
    d = pw.fields_dict(raw)
    if 3 in d:
        return pw.to_signed64(d[3][0])
    return None


def attr_type(raw: Optional[bytes]) -> Optional[int]:
    if raw is None:
        return None
    d = pw.fields_dict(raw)
    return d.get(6, [None])[0]


def attr_float_list(raw: Optional[bytes]) -> List[float]:
    """AttrValue.list.f (packed or repeated fixed32)."""
    if raw is None:
        return []
    d = pw.fields_dict(raw)
    out: List[float] = []
    for lst in d.get(1, []):
        for field, wtype, val in pw.iter_fields(lst):
            if field != 4:
                continue
            if wtype == 2:  # packed
                for i in range(0, len(val), 4):
                    out.append(struct.unpack("<f", val[i : i + 4])[0])
            elif wtype == 5:
                out.append(struct.unpack("<f", val)[0])
    return out


def attr_bool(raw: Optional[bytes]) -> Optional[bool]:
    """AttrValue.b — proto field 5 (field 2 is the bytes ``s`` value;
    reading it here made every transpose_a/transpose_b guard a no-op on
    real graphs, silently importing transposed MatMuls untransposed)."""
    if raw is None:
        return None
    d = pw.fields_dict(raw)
    if 5 in d:
        return bool(d[5][0])
    return None


def attr_shape(raw: Optional[bytes]) -> Optional[List[int]]:
    """AttrValue.shape (TensorShapeProto) -> dim sizes, -1 = unknown."""
    if raw is None:
        return None
    d = pw.fields_dict(raw)
    if 7 not in d:
        return None
    dims: List[int] = []
    for f, _, v in pw.iter_fields(d[7][0]):
        if f == 2:  # TensorShapeProto.dim
            dd = pw.fields_dict(v)
            dims.append(pw.to_signed64(dd.get(1, [0])[0]))
    return dims


def attr_tensor(raw: Optional[bytes]) -> Optional[np.ndarray]:
    """AttrValue.tensor -> numpy array (float32/int32/int64/string)."""
    if raw is None:
        return None
    d = pw.fields_dict(raw)
    if 8 not in d:
        return None
    t = pw.fields_dict(d[8][0])
    dtype = t.get(1, [0])[0]
    shape: List[int] = []
    if 2 in t:
        for f, _, v in pw.iter_fields(t[2][0]):
            if f == 2:  # dim
                dd = pw.fields_dict(v)
                shape.append(pw.to_signed64(dd.get(1, [0])[0]))
    if dtype == DT_STRING:
        # TensorProto.string_val (field 8, repeated bytes)
        vals = t.get(8, [])
        arr = np.asarray(vals, dtype=object)
        if shape:
            arr = arr.reshape(shape)
        return arr
    np_dtype = {DT_FLOAT: np.float32, DT_INT32: np.int32,
                DT_INT64: np.int64, DT_DOUBLE: np.float64}.get(dtype)
    if np_dtype is None:
        return None
    if 4 in t and t[4][0]:
        arr = np.frombuffer(t[4][0], dtype=np_dtype)
    else:
        vals: List = []
        field_no = {DT_FLOAT: 5, DT_DOUBLE: 6, DT_INT32: 7, DT_INT64: 10}[dtype]
        for f, wtype, v in pw.iter_fields(d[8][0]):
            if f != field_no:
                continue
            if wtype == 2 and dtype in (DT_INT32, DT_INT64):  # packed varint
                pos = 0
                while pos < len(v):
                    x, pos = pw.read_varint(v, pos)
                    vals.append(pw.to_signed64(x))
            elif wtype == 2 and dtype == DT_FLOAT:  # packed fixed32
                for i in range(0, len(v), 4):
                    vals.append(struct.unpack("<f", v[i : i + 4])[0])
            elif wtype == 2 and dtype == DT_DOUBLE:  # packed fixed64
                for i in range(0, len(v), 8):
                    vals.append(struct.unpack("<d", v[i : i + 8])[0])
            elif wtype == 5:
                vals.append(struct.unpack("<f", v)[0])
            elif wtype == 1:                         # fixed64 double
                vals.append(struct.unpack("<d", v)[0])
            elif wtype == 0:
                vals.append(pw.to_signed64(v))
        arr = np.asarray(vals, dtype=np_dtype)
    if shape:
        if arr.size == 1 and int(np.prod(shape)) > 1:
            arr = np.full(shape, arr.reshape(-1)[0], dtype=np_dtype)
        else:
            arr = arr.reshape(shape)
    return arr


# ------------------------ graph walking ------------------------------------


def _base(name: str) -> str:
    if name.startswith("^"):
        name = name[1:]
    return name.split(":")[0]


class GraphIndex:
    def __init__(self, nodes: List[Node]):
        self.nodes = nodes
        self.by_name = {n.name: n for n in nodes}
        self.consumers: Dict[str, List[Node]] = {}
        for n in nodes:
            for i in n.inputs:
                self.consumers.setdefault(_base(i), []).append(n)
        # graph-def position per node (construction order) — consumers
        # needing a stable order must not rebuild this O(N) map per slot
        self.order: Dict[int, int] = {id(n): i for i, n in enumerate(nodes)}

    def node(self, name: str) -> Optional[Node]:
        return self.by_name.get(_base(name))

    def backward_set(self, start: Node) -> List[Node]:
        seen: Set[str] = set()
        order: List[Node] = []
        stack = [start]
        while stack:
            n = stack.pop()
            if n.name in seen:
                continue
            seen.add(n.name)
            order.append(n)
            for i in n.inputs:
                nn = self.node(i)
                if nn is not None:
                    stack.append(nn)
        return order


def find_output_concat(gi: GraphIndex, min_inputs: int = 5) -> Node:
    """The input_layer ConcatV2 — the convergence point every FC feeds
    (reference IsConcatOutOp, graph_info.cc:36-39; the TfCpuGpuPass uses the
    same >5-input heuristic, tf_cpu_gpu_pass.cc:47-97)."""
    def widest(min_in: int, sink_only: bool):
        cand = None
        for n in gi.nodes:
            if n.op not in ("ConcatV2", "Concat"):
                continue
            # the input_layer concat is float; int concats are internal
            # shape plumbing (e.g. embedding_lookup_sparse's dynamic
            # reshape) and must never win, however wide
            t = attr_type(n.attr("T"))
            if t is not None and t not in (DT_FLOAT, DT_DOUBLE):
                continue
            if len(n.inputs) - 1 < min_in:
                continue
            if sink_only and gi.consumers.get(n.name):
                continue        # consumed downstream: an internal concat
            if cand is None or len(n.inputs) > len(cand.inputs):
                cand = n
        return cand

    # prefer an OUTPUT (sink) concat — safe_embedding_lookup_sparse's own
    # implementation contains small internal ConcatV2s that must lose to
    # the model's final concat
    best = (
        widest(min_inputs, sink_only=True)
        or widest(min_inputs, sink_only=False)
        # small graphs: the reference's >5 heuristic targets 1000-column
        # input_layers (tf_cpu_gpu_pass.cc:47-97); a 2-column model is
        # still importable
        or widest(2, sink_only=True)
        or widest(2, sink_only=False)
    )
    if best is None:
        raise ValueError("no output ConcatV2 found (need >=2 inputs)")
    return best


def import_tf_graphdef(
    data: bytes,
    tower: Optional[TowerSpec] = None,
    name: str = "imported",
    strict: bool = True,
    checkpoint: Optional[str] = None,
) -> Tuple[ModelSpec, Dict[str, np.ndarray]]:
    """Returns (ModelSpec, frozen table weights by table name).

    ``strict=True`` (default): a column whose transform chain is not
    recognized raises instead of silently importing as identity ids — the
    reference's contract is leave-the-graph-unchanged on match failure,
    and changing semantics silently is worse than failing loudly.  Pass
    ``strict=False`` to opt into the identity-ids degradation (warned).

    ``checkpoint``: TF checkpoint prefix; VariableV2 tables whose values
    are not frozen into the graph are restored from it.

    When the graph carries a frozen dense tower (MatMul/BiasAdd chains
    after the concat) and ``tower`` is not given, the tower is imported
    structurally: TowerSpec + weights (exposed via
    :func:`import_params`)."""
    nodes = parse_graphdef(data)
    gi = GraphIndex(nodes)
    concat = find_output_concat(gi)

    columns: List[FeatureColumn] = []
    col_widths: List[int] = []          # concat-slot width per column
    tables: Dict[str, TableSpec] = {}
    weights: Dict[str, np.ndarray] = {}
    warnings: List[str] = []
    slots_complete = True               # every slot parsed -> tower import ok

    # ConcatV2 carries the axis LAST; V1 Concat carries it FIRST
    value_inputs = (
        concat.inputs[1:] if concat.op == "Concat" else concat.inputs[:-1]
    )
    for inp in value_inputs:
        n = gi.node(inp)
        if n is None:
            slots_complete = False
            continue
        sub = gi.backward_set(n)
        ops = {x.op: x for x in sub}

        placeholders = [x for x in sub if x.op == "Placeholder"]
        # post-lookup column compute detected FIRST: its consumed nodes
        # (a projection MatMul's frozen W const) must not be mistaken for
        # embedding tables, and the residue check below admits its ops
        post, post_ops, post_nodes, post_frontier = _detect_post(gi, inp)
        table_nodes = [
            x for x in sub
            if x.op in ("VariableV2", "VarHandleOp", "Const")
            and _table_shape(x) is not None
            and x.name not in post_nodes
        ]
        if not table_nodes:
            # ---- indicator_column: OneHot(+Sum over the sequence axis)
            # with NO embedding table.  Multi-hot counts == an embedding
            # lookup on an IDENTITY table with the SUM combiner, so it
            # imports as exactly that (a vocab x vocab eye table) -------
            if "OneHot" in ops:
                handled = _import_indicator(
                    gi, ops, sub, inp, placeholders, columns, col_widths,
                    tables, weights, warnings, strict,
                )
                if handled:
                    continue
                slots_complete = False
                continue
            # dense passthrough ONLY when the slot is pure plumbing —
            # anything computational here would be silently dropped
            benign = {
                "Placeholder", "Reshape", "Identity", "Const", "Pack",
                "StridedSlice", "Shape", "Cast", "ExpandDims", "Squeeze",
                "ConcatV2",
            }
            slot_ops = set(x.op for x in sub)
            if not placeholders:
                # e.g. a constant concat slot: nothing to feed at serving
                # time — skip non-fatally (tower import disabled)
                warnings.append(
                    f"slot feeding {n.name}: no placeholders; slot SKIPPED"
                )
                slots_complete = False
                continue
            if not slot_ops <= benign:
                msg = (
                    f"slot feeding {n.name}: no embedding table and "
                    f"unrecognized ops {sorted(slot_ops - benign)}"
                )
                if strict:
                    raise ValueError(
                        msg + " — refusing to import as a dense "
                        "passthrough; pass strict=False to skip the slot"
                    )
                warnings.append(msg + "; slot SKIPPED")
                slots_complete = False
                continue
            # multi-placeholder slots (an inner ConcatV2/Pack of feeds)
            # must emit columns in CONCAT order, not DFS-discovery order
            # (backward_set's stack reverses inputs) — the tower's
            # first-matmul row permutation keys on column order, so a
            # swapped pair would silently map the wrong weight rows
            if len(placeholders) > 1:
                inner = _resolve_through(
                    gi, inp, ("Identity", "Reshape", "ExpandDims",
                              "Squeeze", "Cast")
                )
                ordered_ph = []
                if inner is not None and inner.op in ("ConcatV2", "Concat",
                                                      "Pack"):
                    vins = (
                        inner.inputs[1:] if inner.op == "Concat"
                        else inner.inputs[:-1] if inner.op == "ConcatV2"
                        else inner.inputs
                    )
                    for vi in vins:
                        ph_ = _placeholder_of(gi, vi)
                        if ph_ is not None and ph_ not in ordered_ph:
                            ordered_ph.append(ph_)
                if set(p.name for p in ordered_ph) == set(
                    p.name for p in placeholders
                ):
                    placeholders = ordered_ph
                else:
                    # no provable order: graph-def order (construction
                    # order, which matches feed declaration order)
                    placeholders = sorted(
                        placeholders, key=lambda p: gi.order.get(id(p), 0)
                    )
            for ph in placeholders:
                # numeric_column(shape=(k,)): a [None, k] placeholder is a
                # width-k passthrough occupying k tower-input slots; a
                # bare "width 1" import would silently drop k-1 dims
                shp = attr_shape(ph.attr("shape")) or []
                w = 1
                if len(shp) == 2 and shp[1] > 1:
                    w = int(shp[1])
                columns.append(
                    FeatureColumn(
                        ph.name,
                        FeatureSource(
                            ph.name, FeatureKind.DENSE_FLOAT, width=w
                        ),
                    )
                )
                col_widths.append(w)
            continue

        if len(table_nodes) > 1:
            # two lookups converging inside ONE slot: the pooled-Mul
            # pattern (reference post_lookup_optimizer.cc:480-608)
            if _import_mul_slot(
                gi, inp, columns, col_widths, tables, weights, warnings,
                strict, checkpoint,
            ):
                continue
            msg = (
                f"column feeding {n.name}: {len(table_nodes)} embedding "
                "tables converge in one slot and the shape is not the "
                "pooled-Mul pattern"
            )
            if strict:
                raise ValueError(
                    msg + " — refusing to import one chain and drop the "
                    "other; pass strict=False to skip the slot"
                )
            warnings.append(msg + "; slot SKIPPED")
            slots_complete = False
            continue

        tnode = table_nodes[0]
        vocab, dim = _table_shape(tnode)
        tname = _register_table(tnode, tables, weights, warnings, checkpoint)

        # --- combiner: unweighted SparseSegment* or the weighted
        # embedding_lookup_sparse expansion (Unique+Gather weights, then
        # SegmentSum [+ DivNoNan for mean / sqrt for sqrtn] — the
        # reference's weighted idiom, lookup_optimizer.cc:89-99) ---------
        weighted = False
        cone = _cone_combiner(ops)      # unweighted SparseSegment* idiom
        combiner = cone if cone is not None else Combiner.MEAN
        if cone is None and "SegmentSum" in ops and "Mul" in ops:
            weighted = True
            if "SparseSoftmax" in ops:
                # tf.sparse.softmax on the weight SparseTensor before the
                # weighted sum — the reference's SparseSoftmax +
                # SequenceMask pattern (post_lookup_optimizer.cc:311-478);
                # the engine re-applies the rowwise masked softmax to the
                # RAW score feed at weight-staging time.  sum and mean
                # both map here (softmaxed weights sum to ~1, so the mean
                # divisor is a ~1 ulp rounding difference); sqrtn does NOT
                # (sqrt of the sum of SQUARED softmaxed weights is a real
                # divisor) — refuse rather than silently drop it.
                if "Sqrt" in ops or "Square" in ops or "Pow" in ops:
                    msg = (
                        f"column feeding {n.name}: SparseSoftmax weights "
                        "combined with a sqrtn divisor have no engine "
                        "combiner"
                    )
                    if strict:
                        raise ValueError(
                            msg + " — refusing to change semantics "
                            "silently; pass strict=False to import with "
                            "softmax-sum semantics (warned)"
                        )
                    warnings.append(msg + "; imported as softmax-sum")
                combiner = Combiner.SOFTMAX
            elif "Sqrt" in ops or "Square" in ops or "Pow" in ops:
                combiner = Combiner.SQRTN
            elif "DivNoNan" in ops or "RealDiv" in ops or "Div" in ops:
                combiner = Combiner.MEAN
            else:
                combiner = Combiner.SUM

        # --- pooled-path verification: the value path from the slot's
        # post-peeled frontier back to the pooling/lookup op must be pure
        # plumbing.  Compute here is modeled by NEITHER the combiner NOR
        # the PostPool chain and would be silently dropped — op-presence
        # residue cannot catch it because Mul/Add/Sum legitimately appear
        # pre-lookup (the pooled analogue of _trace_value_source's
        # pre-anchor check) -------------------------------------------------
        bad = _verify_pooled_path(gi, post_frontier, weighted)
        if bad is not None:
            msg = (
                f"column feeding {n.name}: pooled-output path carries "
                f"unmodeled compute ({bad.op} {bad.name}) between the "
                "lookup and the concat"
            )
            if strict:
                raise ValueError(
                    msg + " — refusing to change semantics silently; pass "
                    "strict=False to import without it (warned)"
                )
            warnings.append(msg + "; imported WITHOUT it")

        transforms: tuple = ()
        ragged = "StringSplit" in ops or "StringSplitV2" in ops
        delimiter = None
        if ragged:
            sp = ops.get("StringSplit") or ops.get("StringSplitV2")
            delimiter = _split_delimiter(gi, sp)

        cross = (
            ops.get("SparseCrossHashed")
            or ops.get("SparseCrossV2")
            or ops.get("SparseCross")
        )
        if cross is not None:
            def cross_bail(msg: str) -> bool:
                full = f"crossed column feeding {n.name}: {msg}"
                if strict:
                    raise ValueError(
                        full + " — refusing to change semantics silently; "
                        "pass strict=False to skip the slot"
                    )
                warnings.append(full + "; slot SKIPPED")
                return False

            # the strict contract applies to crosses like every other
            # idiom: only the Fingerprint64/FingerprintCat64 hashed form
            # is modeled (CrossHash); V2's string-concat crosses and
            # non-hashed SparseCross outputs are a different id function
            if cross.op != "SparseCrossHashed" and not attr_bool(
                cross.attr("hashed_output")
            ):
                if not cross_bail(
                    f"{cross.op} without hashed_output has string-concat "
                    "semantics CrossHash cannot reproduce"
                ):
                    slots_complete = False
                    continue
            if weighted:
                if not cross_bail(
                    "weighted crossed columns have no engine expression "
                    "(the weight plane cannot align with crossed tuples)"
                ):
                    slots_complete = False
                    continue
            nb = attr_int(cross.attr("num_buckets")) or vocab
            hk = attr_int(cross.attr("hash_key"))
            # FingerprintCat64 is order-dependent: key order must follow
            # the SparseCross op's INPUT order, not DFS discovery order;
            # each key input's value path must trace to its placeholder
            # (compute between a key feed and the cross would be dropped)
            ordered = []
            bailed = False
            for ci in cross.inputs:
                src_n = gi.node(ci)
                if src_n is not None and src_n.op in (
                    "Const", "Shape", "Pack", "StridedSlice", "Slice",
                    "Prod", "Cast",
                ):
                    continue        # dense_shape / plumbing operands
                src = _trace_value_source(gi, ci)
                if src is None or src.op not in (
                    "Placeholder", "SparseFillEmptyRows", "Where",
                    "GatherNd", "StringSplit", "StringSplitV2",
                ):
                    if not cross_bail(
                        f"cross key input {ci} does not trace to a "
                        "feature feed through value-preserving ops "
                        f"(stops at {src.op if src else '?'})"
                    ):
                        bailed = True
                        break
                ph = _placeholder_of(gi, ci)
                if ph is not None and ph.name not in ordered:
                    ordered.append(ph.name)
            if bailed:
                slots_complete = False
                continue
            fields = tuple(ordered) or tuple(
                ph.name for ph in placeholders
            ) or (n.name,)
            cname = "_x_".join(fields)
            columns.append(
                FeatureColumn(
                    cname,
                    FeatureSource(cname, FeatureKind.CROSS, fields=fields),
                    (CrossHash(nb, hk if hk is not None else 0xDECAFCAFFE),),
                    LookupSpec(tname, combiner),
                    post=post,
                )
            )
            w = dim
            for p in post or ():
                w = p.out_width(w)
            col_widths.append(w)
            continue
        matched = _match_categorical_chain(
            gi, ops, sub, placeholders, warnings, strict=strict
        )
        main_ph: Optional[Node] = None
        if matched is not None:
            transforms, kind, main_ph, ragged, delimiter, _, anchor_kind = (
                matched
            )
            # residue check: ops outside the idiom's measured vocabulary
            # mean the slot computes something this import can't model
            residue = _slot_residue(
                set(x.op for x in sub) - post_ops, anchor_kind,
                weighted=weighted, hosteval=_hosteval_ops(transforms),
            )
            if residue:
                examples = [
                    f"{x.name} ({x.op})" for x in sub if x.op in residue
                ][:3]
                msg = (
                    f"column feeding {n.name}: recognized {anchor_kind} "
                    f"chain carries unmodeled ops {sorted(residue)} "
                    f"(e.g. {', '.join(examples)})"
                )
                if strict:
                    raise ValueError(
                        msg + " — refusing to change semantics silently; "
                        "pass strict=False to import the recognized part "
                        "anyway (warned).  Supported-op contract: "
                        "docs/IMPORT_CONTRACT.md"
                    )
                warnings.append(msg + "; imported WITHOUT them")
        else:
            msg = (
                f"column feeding {n.name}: unrecognized transform chain "
                f"(ops: {sorted(set(x.op for x in sub))})"
            )
            if strict:
                raise ValueError(
                    msg + " — refusing to change semantics silently; pass "
                    "strict=False to import as identity int ids.  "
                    "Supported idioms: docs/IMPORT_CONTRACT.md"
                )
            warnings.append(msg + "; imported as identity int ids")
            kind = FeatureKind.INT_LIST if ragged else FeatureKind.DENSE_INT

        # --- weighted column: the weight feed is the float placeholder
        # that is NOT the id feature, or (ragged) a second delimited
        # string whose split -> StringToNumber(float) feeds the weight
        # sparse plane ---------------------------------------------------
        weight_field = None
        if weighted:
            cands = [
                p for p in placeholders
                if attr_type(p.attr("dtype")) in (DT_FLOAT, DT_DOUBLE)
                and (main_ph is None or p.name != main_ph.name)
            ]
            if len(cands) == 1:
                weight_field = cands[0].name
            else:
                weight_field = _delimited_weight_plane(
                    gi, sub, main_ph, delimiter, warnings
                )
                if weight_field is None:
                    msg = (
                        f"column feeding {n.name}: weighted idiom detected "
                        f"but {len(cands)} float placeholder candidates and "
                        "no delimited weight plane"
                    )
                    if strict:
                        # dropping the weights changes pooling semantics
                        # (for SOFTMAX it silently becomes uniform-score
                        # 1/n pooling) — the strict contract refuses
                        raise ValueError(
                            msg + " — refusing to import with weights "
                            "dropped; pass strict=False to import "
                            "unweighted (warned)"
                        )
                    warnings.append(msg + "; weights NOT imported")

        field = (
            main_ph.name if main_ph is not None
            else placeholders[0].name if placeholders else n.name
        )
        cname = _fresh_name(field, {c.name for c in columns})
        columns.append(
            FeatureColumn(
                cname,
                FeatureSource(field, kind, delimiter=delimiter),
                transforms,
                LookupSpec(tname, combiner, weight_field=weight_field),
                post=post,
            )
        )
        # concat-slot width = table dim folded through the post chain
        # (reduce -> 1, softmax/mul -> dim, matmul -> d_out); a bare
        # "1 if post else dim" broke tower import for the non-reducing
        # post ops
        w = dim
        for p in post or ():
            w = p.out_width(w)
        col_widths.append(w)

    tower_params = None
    if tower is None:
        tower, tower_params = _import_tower(
            gi, concat, columns, col_widths,
            complete=slots_complete, warnings=warnings,
        )
    model = ModelSpec(
        name, tables, columns,
        tower or TowerSpec(arch="mlp", bottom_mlp=(), top_mlp=(),
                           final_activation=None),
    )
    model.import_warnings = warnings  # type: ignore[attr-defined]
    if tower_params is not None:
        model.imported_tower_params = tower_params  # type: ignore[attr-defined]
    return model, weights


def _match_categorical_chain(
    gi: GraphIndex, ops: Dict, sub, placeholders, warnings: List[str],
    allow_identity_ids: bool = False,
    identity_cap: Optional[int] = None,
    strict: bool = False,
):
    """Recognize a concat slot's categorical transform chain — the ONE
    implementation shared by the embedding and indicator import paths.

    Returns (transforms, kind, main_ph, ragged, delimiter, chain_hi,
    anchor_kind) or None when no known idiom matches.  ``chain_hi`` is the
    largest id the chain can produce (None = unbounded), used by callers
    that must match TF's zero-row semantics for over-range ids.
    ``allow_identity_ids`` admits raw-integer-id chains
    (categorical_column_with_identity) as NumToId(identity_cap).

    ``strict``: op PRESENCE matching alone would silently drop compute
    sitting between the placeholder and the anchor op (e.g. Placeholder ->
    Mul(2.0) -> Bucketize imports as Bucketize(placeholder)).  Strict mode
    therefore verifies the anchor's VALUE path reaches a Placeholder
    through value-preserving ops only (_trace_value_source) and raises on
    anything else — mirroring the reference's leave-unchanged-on-mismatch
    contract (RETURN_IF_FALSE discipline, fc_optimizer_base.h:202-257)."""
    ragged = "StringSplit" in ops or "StringSplitV2" in ops
    delimiter = None
    if ragged:
        sp = ops.get("StringSplit") or ops.get("StringSplitV2")
        delimiter = _split_delimiter(gi, sp)
        if delimiter is None:
            # whitespace-run / per-character / multi-byte split: no
            # single-byte wire convention can reproduce it — refuse the
            # match (strict raises) instead of silently splitting on ';'
            warnings.append(
                f"split {sp.name}: whitespace/per-char/multi-byte "
                "delimiter has no single-byte wire form; chain NOT matched"
            )
            return None
    range_pairs = _extract_range_transforms(gi, sub, warnings)
    vocab_tf, vocab_int_keys = _vocab_transform(gi, ops, warnings)
    main_ph = None
    chain_hi: Optional[int] = None
    anchor_input: Optional[str] = None
    if vocab_tf is not None:
        anchor_kind = "vocab"
        transforms = (vocab_tf,)
        find = ops.get("LookupTableFindV2") or ops.get("LookupTableFind")
        anchor_input = find.inputs[1]
        main_ph = _placeholder_of(gi, find.inputs[1])
        kind = (
            FeatureKind.STRING_LIST if ragged
            else FeatureKind.DENSE_INT if vocab_int_keys
            else FeatureKind.STRING
        )
        chain_hi = len(vocab_tf.vocab) + max(vocab_tf.num_oov, 0) - 1
        if vocab_tf.num_oov == 0:
            chain_hi = max(chain_hi, vocab_tf.default)
    elif "Bucketize" in ops:
        anchor_kind = "bucketize"
        bz = ops["Bucketize"]
        bounds = attr_float_list(bz.attr("boundaries"))
        transforms = (Bucketize(bounds),)
        kind = FeatureKind.DENSE_FLOAT
        anchor_input = bz.inputs[0]
        main_ph = _placeholder_of(gi, bz.inputs[0])
        chain_hi = len(bounds)
    elif "StringToHashBucketFast" in ops:
        anchor_kind = "hash"
        hb = ops["StringToHashBucketFast"]
        nb = attr_int(hb.attr("num_buckets"))
        transforms = (HashBucket(nb),)
        anchor_input = hb.inputs[0]
        main_ph = _placeholder_of(gi, hb.inputs[0])
        if ragged:
            kind = FeatureKind.STRING_LIST
        elif "AsString" in ops or _ph_dtype(placeholders) in (
            DT_INT32, DT_INT64
        ):
            kind = FeatureKind.DENSE_INT
        else:
            kind = FeatureKind.STRING
        chain_hi = (nb or 0) - 1 if nb else None
    else:
        # No transform anchor op at all.  Before giving up, try the
        # run-anything fallback on the WHOLE id value path: an anchor-less
        # chain like Placeholder -> Div(2) -> lookup carries real compute
        # that compiles to a bounded host evaluator (the reference serves
        # such unmatched segments on CPU, cuda_emitter.cc:141-154).  The
        # id values enter the sparse machinery at SparseFillEmptyRows
        # (indices, VALUES, shape, default) or SparseToDense
        # (indices, shape, VALUES, default).
        # candidate id-value entries: a weighted slot carries TWO sparse
        # planes (ids AND weights, each with its own SparseFillEmptyRows)
        # — probe every one and keep the first whose value path yields
        # integer ids
        entries = [x.inputs[1] for x in sub
                   if x.op == "SparseFillEmptyRows" and len(x.inputs) > 1]
        entries += [x.inputs[2] for x in sub
                    if x.op == "SparseToDense" and len(x.inputs) > 2]
        # identity-with-default emits where(out_of_range, fill(d), v) ON
        # the value path — its SelectRange is extracted by
        # _extract_range_transforms; the trace follows the value branch
        entries = [_peel_value_selects(gi, e) for e in entries]
        steps = he_ph = src = id_entry = None
        for entry in entries:
            st, ph_ = _compile_host_eval(gi, entry)
            if st is not None and st[-1][2] in ("i32", "i64"):
                steps, he_ph, id_entry = st, ph_, entry
                break
        if steps is None:
            for entry in entries:
                s_ = _trace_value_source(gi, entry)
                if (
                    s_ is not None and s_.op == "Placeholder"
                    and attr_type(s_.attr("dtype")) in (DT_INT32, DT_INT64)
                ):
                    src, id_entry = s_, entry
                    break
                if (
                    s_ is not None and s_.op == "StringToNumber"
                    and ragged
                    and attr_type(s_.attr("out_type")) in (DT_INT32, DT_INT64)
                    and s_.inputs
                ):
                    # delimited int-list idiom: split(string) ->
                    # StringToNumber(int) -> raw ids.  INT_LIST with the
                    # split's delimiter parses the pieces as decimal ints
                    # — the same observable semantics.  Float out_types
                    # are NOT admitted (an f32 round-trip perturbs ids
                    # past 2^24, which a silent import must not do).
                    s2 = _trace_value_source(gi, s_.inputs[0])
                    if (
                        s2 is not None and s2.op == "Placeholder"
                        and attr_type(s2.attr("dtype")) == DT_STRING
                    ):
                        src, id_entry = s2, entry
                        break
        if steps is not None and steps[-1][2] in ("i32", "i64"):
            anchor_kind = "hosteval"
            transforms = (HostEvalChain(steps),)
            main_ph = he_ph
            # raggedness comes from the ID path itself (NOT slot-wide op
            # presence: a StringSplit elsewhere in the cone may belong to
            # the WEIGHT plane, and declaring the int id feed INT_LIST
            # with its delimiter would crash serving)
            he_dt = attr_type(he_ph.attr("dtype"))
            if he_dt == DT_STRING:
                kind = FeatureKind.INT_LIST
                ragged = True
                delimiter = _split_delim_on_path(gi, id_entry) or delimiter
            elif he_dt in (DT_FLOAT, DT_DOUBLE):
                kind = FeatureKind.DENSE_FLOAT
                ragged, delimiter = False, None
            else:
                kind = FeatureKind.DENSE_INT
                ragged, delimiter = False, None
            warnings.append(
                "anchor-less chain: id path compiled to a host evaluator "
                f"{[s[0] for s in steps]} (served bit-exact on host)"
            )
        elif src is not None:
            # (dtype/idiom validity was established by the probe loop
            # that set ``src``)
            # raw integer ids fed straight into the lookup machinery
            # (categorical_column_with_identity / hand-built id feeds):
            # safe under strict because the value path is VERIFIED to
            # reach the placeholder through value-preserving ops only —
            # nothing is dropped.  Bounds behavior comes from the
            # extracted range transforms (the prune-invalid idiom) plus
            # the engine's canonicalize clamp contract.
            anchor_kind = "identity"
            transforms = ()
            main_ph = src
            if attr_type(src.attr("dtype")) == DT_STRING:
                # the split -> StringToNumber(int) idiom: delimiter read
                # from the ID path's own split
                kind = FeatureKind.INT_LIST
                ragged = True
                delimiter = _split_delim_on_path(gi, id_entry) or delimiter
            else:
                kind = FeatureKind.DENSE_INT
                ragged, delimiter = False, None
        elif (
            allow_identity_ids
            and _ph_dtype(placeholders) in (DT_INT32, DT_INT64)
        ):
            # indicator/OneHot path (no sparse entry to trace from)
            from recom_tpu_torch.ir.spec import NumToId

            anchor_kind = "identity"
            transforms = (NumToId(identity_cap),)
            main_ph = placeholders[0] if placeholders else None
            kind = FeatureKind.INT_LIST if ragged else FeatureKind.DENSE_INT
        else:
            return None
    if anchor_input is not None:
        src = _trace_value_source(gi, anchor_input)
        if src is not None and src.op == "Placeholder":
            main_ph = src       # the verified value source beats the
                                # first-reachable-placeholder BFS guess
        else:
            # run-anything fallback: compile the blocked segment into a
            # bounded host evaluator when it is elementwise const-operand
            # arithmetic (the reference serves unmatched segments on CPU,
            # cuda_emitter.cc:141-154; HostEvalChain is our equivalent)
            steps, ph = _compile_host_eval(gi, anchor_input)
            if steps is not None:
                transforms = (HostEvalChain(steps),) + transforms
                main_ph = ph
                warnings.append(
                    f"{anchor_kind} chain: pre-anchor compute "
                    f"{[s[0] for s in steps]} compiled to a host "
                    "evaluator (served bit-exact on host)"
                )
            else:
                msg = (
                    f"{anchor_kind} chain: value path from the anchor's "
                    f"input ({anchor_input}) does not reach a Placeholder "
                    "through value-preserving ops (stops at "
                    f"{src.op + ' ' + src.name if src is not None else 'a cycle'})"
                    " — the intervening computation would be silently "
                    "dropped"
                )
                if strict:
                    raise ValueError(
                        msg + "; pass strict=False to import the "
                        "recognized part anyway (warned).  Supported "
                        "pre-anchor math: docs/IMPORT_CONTRACT.md"
                    )
                warnings.append(msg + "; imported WITHOUT it")
    # range idioms append AFTER the final main_ph resolution so the
    # subject check compares against the VERIFIED id feed, not the
    # first-reachable-placeholder BFS guess.  String-plane filters act on
    # raw values and must run BEFORE the chain's string->id anchor;
    # integer-range idioms act on ids and run after it.
    from recom_tpu_torch.ir.spec import FilterStrSentinel

    ranged = _range_for(range_pairs, main_ph, warnings)
    str_filters = tuple(
        t for t in ranged if isinstance(t, FilterStrSentinel)
    )
    transforms = str_filters + transforms + tuple(
        t for t in ranged if not isinstance(t, FilterStrSentinel)
    )
    return transforms, kind, main_ph, ragged, delimiter, chain_hi, anchor_kind


def _detect_post(gi: GraphIndex, inp: str):
    """Post-lookup column compute at the slot tail: Sum/Mean over the
    embedding dim (the reference's BatchColReduction, cuda_emitter.cc:
    1180-1244), Softmax over the embedding dim (the SparseSoftmax
    pattern, post_lookup_optimizer.cc:311-478, in the pooled domain),
    a frozen MatMul projection (the push-MatMul-under-sparse rewrite,
    post_lookup_optimizer.cc:227-309 — sum/mean pooling is linear, so the
    projection commutes with it), or elementwise affine with a frozen
    const operand (Mul/Add/Sub by a scalar or per-dim vector —
    PostPool("affine")).  Ops peel tail-first into a chain.
    Returns (post tuple, ops the post chain accounts for, node NAMES the
    chain consumes — e.g. a MatMul's frozen W const, which must not be
    mistaken for an embedding table by slot analysis, and the FRONTIER
    tensor name left after peeling, whose path back to the pooling op the
    caller verifies with _verify_pooled_path)."""
    from recom_tpu_torch.ir.spec import PostPool

    chain: list = []                    # built tail-first, reversed below
    accounted: set = set()
    node_names: set = set()
    cur = inp
    for _ in range(6):                  # bounded peel
        red = _resolve_through(
            gi, cur, ("Identity", "Reshape", "ExpandDims", "Squeeze")
        )
        if red is None:
            break
        if red.op in ("Sum", "Mean") and len(red.inputs) > 1:
            ax = _const_scalar(gi, red.inputs[1])
            if ax not in (1, -1):
                break
            chain.append(PostPool(
                "reduce_sum" if red.op == "Sum" else "reduce_mean"
            ))
            accounted.add(red.op)
            node_names.add(red.name)
            cur = red.inputs[0]
            continue
        if red.op == "Softmax":
            # tf.nn.softmax defaults to the LAST axis = the embedding dim
            # of the pooled [B, d] output
            chain.append(PostPool("softmax"))
            accounted.add("Softmax")
            node_names.add(red.name)
            cur = red.inputs[0]
            continue
        if red.op == "MatMul" and len(red.inputs) == 2:
            # x @ W with a frozen W on input 1 and no transposes (the
            # reference declines transpose_a too, cc:247-249)
            if attr_bool(red.attr("transpose_a")) or attr_bool(
                red.attr("transpose_b")
            ):
                break
            wnode = _resolve_through(gi, red.inputs[1])
            if wnode is None or wnode.op != "Const":
                break
            w = attr_tensor(wnode.attr("value"))
            if w is None or w.ndim != 2:
                break
            chain.append(PostPool(
                "matmul",
                weight=tuple(
                    tuple(float(v) for v in row)
                    for row in np.asarray(w, np.float32)
                ),
            ))
            accounted.add("MatMul")
            node_names.add(red.name)
            node_names.add(wnode.name)
            cur = red.inputs[0]
            continue
        if red.op in ("Mul", "Add", "AddV2", "Sub") and len(red.inputs) >= 2:
            # elementwise affine with a frozen const operand on the pooled
            # [B, d] output.  Two pooled lookups multiplied (both operands
            # non-Const) is the mul-slot idiom, handled by the caller —
            # the const requirement keeps the two patterns disjoint.
            cnode = _resolve_through(gi, red.inputs[1])
            cv, xin, const_left = None, None, False
            if cnode is not None and cnode.op == "Const":
                cv, xin = attr_tensor(cnode.attr("value")), red.inputs[0]
            else:
                cnode = _resolve_through(gi, red.inputs[0])
                if cnode is not None and cnode.op == "Const":
                    cv, xin = attr_tensor(cnode.attr("value")), red.inputs[1]
                    const_left = True
            if cv is None or np.asarray(cv).ndim > 1:
                break
            c = tuple(
                float(v) for v in
                np.atleast_1d(np.asarray(cv, np.float32))
            )
            if red.op == "Mul":
                chain.append(PostPool("affine", scale=c))
            elif red.op in ("Add", "AddV2"):
                chain.append(PostPool("affine", bias=c))
            elif not const_left:        # Sub(x, c): x + (-c), bit-equal
                chain.append(PostPool(
                    "affine", bias=tuple(-v for v in c)
                ))
            else:                       # Sub(c, x): x*(-1) + c, bit-equal
                chain.append(PostPool("affine", scale=(-1.0,), bias=c))
            accounted.add(red.op)
            node_names.add(red.name)
            node_names.add(cnode.name)
            cur = xin
            continue
        break
    return tuple(reversed(chain)), accounted, node_names, cur


def _register_table(tnode, tables, weights, warnings, checkpoint):
    """TableSpec + frozen weights for a table node (Const / VariableV2)."""
    vocab, dim = _table_shape(tnode)
    tname = tnode.name
    if tname in tables:
        return tname
    tables[tname] = TableSpec(tname, vocab, dim)
    tv = attr_tensor(tnode.attr("value")) if tnode.op == "Const" else None
    if tv is not None:
        weights[tname] = tv.astype(np.float32)
    elif checkpoint is not None:
        ck = load_checkpoint_tables(checkpoint, [tname])
        if tname in ck:
            weights[tname] = ck[tname]
        else:
            warnings.append(
                f"table {tname}: not found in checkpoint {checkpoint}; "
                "randomly initialized"
            )
    else:
        warnings.append(
            f"table {tname}: VariableV2 values not in graph; pass "
            "checkpoint= or restore separately (randomly initialized "
            "otherwise)"
        )
    return tname


def _cone_combiner(ops: Dict):
    """Unweighted combiner of one lookup cone, or None."""
    if "SparseSegmentSum" in ops or "SparseSegmentSumWithNumSegments" in ops:
        return Combiner.SUM
    if (
        "SparseSegmentSqrtN" in ops
        or "SparseSegmentSqrtNWithNumSegments" in ops
    ):
        return Combiner.SQRTN
    if (
        "SparseSegmentMean" in ops
        or "SparseSegmentMeanWithNumSegments" in ops
    ):
        return Combiner.MEAN
    return None


def _import_mul_slot(
    gi, inp, columns, col_widths, tables, weights, warnings, strict,
    checkpoint,
) -> bool:
    """One concat slot = Mul of TWO pooled embedding lookups — the
    reference's push-Mul-under-sparse pattern (post_lookup_optimizer.cc:
    480-608) observed at the pooled output.  Imports as: operand A as a
    visible column with post=(mul_column other=B), operand B as a HIDDEN
    column (in_concat=False) that pools but occupies no concat slot.
    Returns True when the slot was emitted; failures bail (strict raises
    upstream via the multi-table guard)."""
    from recom_tpu_torch.ir.spec import PostPool

    mul = _resolve_through(
        gi, inp, ("Identity", "Reshape", "ExpandDims", "Squeeze")
    )
    if mul is None or mul.op != "Mul" or len(mul.inputs) < 2:
        return False
    cones = []
    for operand in mul.inputs[:2]:
        start = gi.node(operand)
        if start is None:
            return False
        sub = gi.backward_set(start)
        ops = {x.op: x for x in sub}
        tnodes = [
            x for x in sub
            if x.op in ("VariableV2", "VarHandleOp", "Const")
            and _table_shape(x) is not None
        ]
        if len(tnodes) != 1:
            return False
        combiner = _cone_combiner(ops)
        if combiner is None:
            return False
        phs = [x for x in sub if x.op == "Placeholder"]
        matched = _match_categorical_chain(
            gi, ops, sub, phs, warnings, strict=strict
        )
        if matched is None:
            return False
        transforms, kind, main_ph, ragged, delimiter, _, anchor_kind = (
            matched
        )
        if _slot_residue(set(x.op for x in sub), anchor_kind,
                         hosteval=_hosteval_ops(transforms)):
            return False
        # the operand must BE a pooled lookup output (through plumbing):
        # compute between the pooling op and the Mul (an inner Mul by a
        # const, a Sum reduction, ...) has no expression in mul_column's
        # RAW-pooled-operand contract and must not import silently
        if _verify_pooled_path(gi, operand) is not None:
            return False
        cones.append((
            tnodes[0], combiner, transforms, kind, main_ph, ragged,
            delimiter,
        ))
    # elementwise Mul requires equal pooled widths: a broadcast Mul (e.g.
    # gating by a [V,1] table) is NOT this pattern — bail so the caller's
    # multi-table guard skips-and-warns instead of crashing model
    # validation after import
    dims = [_table_shape(c[0])[1] for c in cones]
    if dims[0] != dims[1]:
        return False
    taken = {c.name for c in columns}

    def fresh(base: str) -> str:
        name = _fresh_name(base, taken)
        taken.add(name)
        return name

    emitted = []
    for tnode, combiner, transforms, kind, main_ph, ragged, delimiter in (
        cones
    ):
        tname = _register_table(tnode, tables, weights, warnings, checkpoint)
        field = main_ph.name if main_ph is not None else tnode.name
        emitted.append((
            fresh(field), FeatureSource(field, kind, delimiter=delimiter),
            transforms, LookupSpec(tname, combiner),
        ))
    (a_name, a_src, a_tf, a_lk), (b_name, b_src, b_tf, b_lk) = emitted
    columns.append(
        FeatureColumn(
            b_name, b_src, b_tf, b_lk, in_concat=False,
        )
    )
    col_widths.append(0)
    columns.append(
        FeatureColumn(
            a_name, a_src, a_tf, a_lk,
            post=(PostPool("mul_column", other=b_name),),
        )
    )
    col_widths.append(tables[a_lk.table].dim)
    return True


def _import_indicator(
    gi, ops, sub, inp, placeholders, columns, col_widths, tables, weights,
    warnings, strict,
) -> bool:
    """tf.feature_column.indicator_column: multi-hot counts over the
    categorical's vocab.  Equal to an embedding lookup on an IDENTITY
    table with the SUM combiner (count per slot == sum of one-hot rows),
    so it imports as a vocab x vocab eye TableSpec + frozen eye weights.
    Over-range ids reproduce TF's zero rows via an appended FilterRange.
    Returns True when the column was emitted; under strict=True any
    unmatched detail RAISES (never silent semantic change)."""
    def bail(msg: str) -> bool:
        full = f"indicator column: {msg}"
        if strict:
            raise ValueError(
                full + " — refusing to change semantics silently; pass "
                "strict=False to skip the slot with a warning"
            )
        warnings.append(full + "; slot NOT imported")
        return False

    oh = ops["OneHot"]
    depth = _const_scalar(gi, oh.inputs[1]) if len(oh.inputs) > 1 else None
    if depth is None:
        return bail("OneHot depth is not a frozen scalar")
    depth = int(depth)
    if depth > 4096:
        return bail(
            f"vocab {depth} too wide for a dense multi-hot (identity "
            "table would be vocab^2 floats)"
        )
    # must be the plain 0/1 multi-hot, not a scaled/shifted one-hot
    on = _const_scalar(gi, oh.inputs[2]) if len(oh.inputs) > 2 else 1.0
    off = _const_scalar(gi, oh.inputs[3]) if len(oh.inputs) > 3 else 0.0
    if on != 1.0 or off != 0.0:
        return bail(f"OneHot on/off values ({on}, {off}) are not 1/0")
    # the slot must consume the OneHot through reshape plumbing, with at
    # most a Sum over the sequence axis (the multi-hot reduction) — any
    # other compute between OneHot and the concat is not an indicator
    red = _resolve_through(
        gi, inp, ("Identity", "Reshape", "ExpandDims", "Squeeze")
    )
    if red is None or red.op not in ("Sum", "OneHot"):
        return bail(
            "ops between OneHot and the concat are not understood "
            f"({red.op if red is not None else '?'})"
        )
    if red.op == "Sum":
        # the multi-hot reduction sums the SEQUENCE axis (axis 1 of the
        # [B, L, depth] one-hot); a Sum over any other axis (e.g. the
        # depth axis) is a different computation and must not import as
        # the sequence reduction
        ax = _const_scalar(gi, red.inputs[1]) if len(red.inputs) > 1 else None
        if ax not in (1, -2):
            return bail(
                f"multi-hot Sum reduces axis {ax}, not the sequence axis "
                "(1) of the [batch, seq, depth] one-hot"
            )

    matched = _match_categorical_chain(
        gi, ops, sub, placeholders, warnings,
        allow_identity_ids=True, identity_cap=depth, strict=strict,
    )
    if matched is None:
        return bail(
            "unrecognized categorical chain "
            f"(ops: {sorted(set(x.op for x in sub))})"
        )
    transforms, kind, main_ph, ragged, delimiter, chain_hi, anchor_kind = (
        matched
    )
    residue = _slot_residue(
        set(x.op for x in sub), anchor_kind, indicator=True,
        hosteval=_hosteval_ops(transforms),
    )
    if residue:
        examples = [
            f"{x.name} ({x.op})" for x in sub if x.op in residue
        ][:3]
        return bail(
            f"recognized {anchor_kind} chain carries unmodeled ops "
            f"{sorted(residue)} (e.g. {', '.join(examples)}); see "
            "docs/IMPORT_CONTRACT.md"
        )
    if anchor_kind == "identity":
        # no anchor op to trace from: verify the one-hot's id path instead
        # (peeling the identity default_value select, whose SelectRange
        # the chain matcher already extracted)
        src = _trace_value_source(gi, _peel_value_selects(gi, oh.inputs[0]))
        if src is None or src.op != "Placeholder":
            return bail(
                "identity-id value path does not reach a Placeholder "
                "through value-preserving ops (stops at "
                f"{src.op + ' ' + src.name if src is not None else 'a cycle'})"
                "; see docs/IMPORT_CONTRACT.md"
            )
        main_ph = src
    if chain_hi is None or chain_hi > depth - 1:
        # TF's one_hot emits an all-zero row for ids outside [0, depth);
        # a trailing FilterRange reproduces that exactly (filtered entries
        # contribute nothing to the SUM)
        from recom_tpu_torch.ir.intervals import IntervalSet
        from recom_tpu_torch.ir.spec import FilterRange

        transforms = transforms + (
            FilterRange(IntervalSet.closed(0, depth - 1)),
        )

    field = (
        main_ph.name if main_ph is not None
        else placeholders[0].name if placeholders else oh.name
    )
    cname = _fresh_name(field, {c.name for c in columns})
    tname = f"__indicator_eye_{depth}"
    if tname not in tables:
        tables[tname] = TableSpec(tname, depth, depth)
        weights[tname] = np.eye(depth, dtype=np.float32)
    columns.append(
        FeatureColumn(
            cname,
            FeatureSource(field, kind, delimiter=delimiter),
            transforms,
            LookupSpec(tname, Combiner.SUM),
        )
    )
    col_widths.append(depth)
    return True


def import_params(model: ModelSpec, weights: Dict[str, np.ndarray]) -> Dict:
    """Full parameter pytree for an imported model: init everything, then
    overlay the frozen table weights and (when the graph carried one) the
    imported dense tower."""
    from recom_tpu_torch.utils.params import init_model_params

    params = init_model_params(model)
    for t, w in weights.items():
        if t in params["tables"]:
            params["tables"][t] = np.asarray(w, np.float32)
    tower_params = getattr(model, "imported_tower_params", None)
    if tower_params is not None:
        params["tower"]["top"] = tower_params
    return params


def load_checkpoint_tables(
    ckpt_prefix: str, table_names: List[str]
) -> Dict[str, np.ndarray]:
    """Read embedding-table values from a TF checkpoint bundle — the
    deployment shape where VariableV2 values live beside the GraphDef
    instead of frozen into it (VERDICT r01: VariableV2 tables must import
    real weights).  Uses TensorFlow's bundle reader; raises ImportError
    with guidance when TF is unavailable (the bundle format has no stable
    pure-python spec)."""
    try:
        from tensorflow.python.training.py_checkpoint_reader import (
            NewCheckpointReader,
        )

        reader = NewCheckpointReader(ckpt_prefix)
    except ImportError as e:
        raise ImportError(
            "reading TF checkpoint bundles requires tensorflow "
            "(pip install tensorflow-cpu), or freeze the graph with "
            "convert_variables_to_constants instead"
        ) from e
    out: Dict[str, np.ndarray] = {}
    have = reader.get_variable_to_shape_map()
    for nm in table_names:
        for cand in (nm, nm + "/part_0", nm.split(":")[0]):
            if cand in have:
                out[nm] = np.asarray(reader.get_tensor(cand), np.float32)
                break
    return out


_ACT_OPS = {"Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh"}


def _import_tower(
    gi: GraphIndex,
    concat: Node,
    columns: List[FeatureColumn],
    col_widths: List[int],
    complete: bool,
    warnings: List[str],
):
    """Parse the frozen dense tower after the concat: a chain of
    MatMul(Const) [-> BiasAdd(Const)] [-> Relu/Sigmoid/Tanh] layers
    (VERDICT r01: import the tower or delete the claim — this imports it).

    Returns (TowerSpec, top-MLP params in engine layout) or (None, None).
    The first matmul's input rows follow TF's concat-slot order; they are
    permuted to the engine's [dense columns..., embedding columns...]
    layout here so downstream code needs no remapping."""
    layers: List[Tuple[np.ndarray, Optional[np.ndarray], Optional[str]]] = []
    cur = concat
    while True:
        cons = [
            c for c in gi.consumers.get(cur.name, [])
            if c.op not in ("Shape", "NoOp")
        ]
        while len(cons) == 1 and cons[0].op == "Identity":
            cur = cons[0]
            cons = [
                c for c in gi.consumers.get(cur.name, [])
                if c.op not in ("Shape", "NoOp")
            ]
        mms = [c for c in cons if c.op == "MatMul"]
        if len(mms) != 1:
            break
        mm = mms[0]
        if attr_bool(mm.attr("transpose_a")) or attr_bool(
            mm.attr("transpose_b")
        ):
            warnings.append(
                f"tower: transposed MatMul {mm.name} not supported; tower "
                "NOT imported"
            )
            return None, None
        widx = 1 if _base(mm.inputs[0]) == cur.name else 0
        w = _const_tensor_through(gi, mm.inputs[widx])
        if w is None or w.ndim != 2:
            warnings.append(
                f"tower: MatMul {mm.name} weights are not frozen; tower "
                "NOT imported"
            )
            return None, None
        cur = mm
        bias = None
        cons2 = [
            c for c in gi.consumers.get(cur.name, []) if c.op != "Shape"
        ]
        if len(cons2) == 1 and cons2[0].op in ("BiasAdd", "Add", "AddV2"):
            other = (
                cons2[0].inputs[1]
                if _base(cons2[0].inputs[0]) == cur.name
                else cons2[0].inputs[0]
            )
            bias = _const_tensor_through(gi, other)
            if bias is None:
                # a live (non-frozen) bias: importing with zeros would
                # silently change predictions — refuse the whole tower
                warnings.append(
                    f"tower: bias of {cons2[0].name} is not frozen; "
                    "tower NOT imported"
                )
                return None, None
            cur = cons2[0]
        act = None
        cons3 = [
            c for c in gi.consumers.get(cur.name, []) if c.op != "Shape"
        ]
        if len(cons3) == 1 and cons3[0].op in _ACT_OPS:
            act = _ACT_OPS[cons3[0].op]
            cur = cons3[0]
        layers.append((w.astype(np.float32), bias, act))

    # the walk must end at output plumbing: compute still hanging off the
    # frontier (a BiasAdd next to a second consumer, a trailing Softmax,
    # an activation outside _ACT_OPS) means a TRUNCATED tower — importing
    # it with the tail dropped silently changes predictions
    frontier, seen, residual = [cur], set(), set()
    while frontier:
        x = frontier.pop()
        for c in gi.consumers.get(x.name, []):
            if c.name in seen:
                continue
            seen.add(c.name)
            if c.op in ("Shape", "NoOp"):
                continue
            if c.op == "Identity":
                frontier.append(c)
                continue
            residual.add(c.op)
    if residual:
        warnings.append(
            "tower: compute remains after the recognized layers "
            f"({sorted(residual)}); importing a truncated tower would "
            "silently change predictions; tower NOT imported"
        )
        return None, None

    if not layers:
        return None, None
    if not complete:
        warnings.append(
            "tower found after concat but some concat slots failed to "
            "import; tower NOT imported (row mapping unknown)"
        )
        return None, None

    # slot-order -> engine-order row permutation of the first layer
    starts = np.concatenate([[0], np.cumsum(col_widths)[:-1]])
    by_col = {c.name: (int(s), int(wd)) for c, s, wd in
              zip(columns, starts, col_widths)}
    total = int(np.sum(col_widths))
    if layers[0][0].shape[0] != total:
        warnings.append(
            f"tower: first MatMul expects {layers[0][0].shape[0]} rows, "
            f"concat provides {total}; tower NOT imported"
        )
        return None, None
    perm: List[int] = []
    for c in columns:
        if c.lookup is None:                 # dense columns first
            s, wd = by_col[c.name]
            perm.extend(range(s, s + wd))
    for c in columns:
        if c.lookup is not None:             # then embeddings, model order
            s, wd = by_col[c.name]
            perm.extend(range(s, s + wd))

    inner_acts = {a for _, _, a in layers[:-1] if a is not None}
    if len(inner_acts) > 1:
        warnings.append(
            f"tower: mixed hidden activations {inner_acts}; tower NOT "
            "imported"
        )
        return None, None
    # a hidden layer with NO activation can't be represented (TowerSpec
    # applies one activation to every hidden layer)
    if any(a is None for _, _, a in layers[:-1]):
        warnings.append(
            "tower: linear hidden layer (no activation); tower NOT "
            "imported"
        )
        return None, None

    params = []
    for i, (w, b, _) in enumerate(layers):
        if i == 0:
            w = w[np.asarray(perm, np.int64)]
        params.append({
            "w": np.ascontiguousarray(w, np.float32),
            "b": (
                np.zeros(w.shape[1], np.float32) if b is None
                else np.asarray(b, np.float32).reshape(-1)
            ),
        })
    spec = TowerSpec(
        arch="mlp",
        bottom_mlp=(),
        top_mlp=tuple(int(w.shape[1]) for w, _, _ in layers),
        activation=next(iter(inner_acts), "relu"),
        final_activation=layers[-1][2],
    )
    return spec, params


def import_tf_saved_model(
    path: str,
    tower: Optional[TowerSpec] = None,
    name: str = "imported",
    strict: bool = True,
    checkpoint: Optional[str] = None,
) -> Tuple[ModelSpec, Dict[str, np.ndarray]]:
    """Import from a SavedModel directory — the deployment artifact TF
    Serving loads, i.e. exactly where the reference's optimization pass
    runs inside the session (fc_optimize_pass.cc registration).  Reads
    saved_model.pb TF-free via the protowire walker
    (SavedModel.meta_graphs[0].graph_def); variables may be frozen into
    the graph (the reference's AE export shape, simple_save + freeze) or
    live — VariableV2 AND resource-variable (VarHandleOp/ResourceGather,
    what modern TF's input_layer emits) tables restore automatically from
    the bundled variables/ checkpoint when present.  Also accepts a bare
    saved_model.pb file path."""
    import os

    pb = path
    if os.path.isdir(path):
        pb = os.path.join(path, "saved_model.pb")
        if checkpoint is None:
            vp = os.path.join(path, "variables", "variables")
            if os.path.exists(vp + ".index"):
                checkpoint = vp
    with open(pb, "rb") as f:
        data = f.read()
    # SavedModel.meta_graphs (field 2) -> MetaGraphDef.graph_def (field 2)
    graph_bytes = None
    for field, _, val in pw.iter_fields(data):
        if field == 2:
            for f2, _, v2 in pw.iter_fields(val):
                if f2 == 2:
                    graph_bytes = v2
                    break
        if graph_bytes:
            break
    if graph_bytes is None:
        raise ValueError(f"no MetaGraphDef.graph_def found in {pb}")
    return import_tf_graphdef(
        graph_bytes, tower=tower, name=name, strict=strict,
        checkpoint=checkpoint,
    )


def _table_shape(n: Node) -> Optional[Tuple[int, int]]:
    """2-D float shape of a variable/const that looks like an embedding
    table (from the 'shape' attr or the const value)."""
    if n.op == "Const":
        t = attr_tensor(n.attr("value"))
        if t is not None and t.ndim == 2 and t.dtype in (np.float32, np.float64):
            return int(t.shape[0]), int(t.shape[1])
        return None
    raw = n.attr("shape")
    if raw is None:
        return None
    d = pw.fields_dict(raw)
    if 7 not in d:
        return None
    dims = []
    for f, _, v in pw.iter_fields(d[7][0]):
        if f == 2:
            dd = pw.fields_dict(v)
            dims.append(pw.to_signed64(dd.get(1, [0])[0]))
    if len(dims) == 2:
        return int(dims[0]), int(dims[1])
    return None


def _ph_dtype(placeholders: List[Node]) -> Optional[int]:
    for ph in placeholders:
        t = attr_type(ph.attr("dtype"))
        if t is not None:
            return t
    return None


_CMP_OPS = {
    "Greater": ">", "GreaterEqual": ">=", "Less": "<", "LessEqual": "<=",
    "Equal": "==", "NotEqual": "!=",
}
_CMP_MIRROR = {">": "<", ">=": "<=", "<": ">", "<=": ">=", "==": "==",
               "!=": "!="}


def _const_scalar(gi: GraphIndex, name: str):
    n = gi.node(name)
    if n is None or n.op != "Const":
        return None
    t = attr_tensor(n.attr("value"))
    if t is None or t.size != 1:
        return None
    return t.reshape(()).item()


def _pred_to_intervals(gi: GraphIndex, name: str):
    """Compile a boolean predicate subtree into an IntervalSet over the id
    chain — the reference's MatchExpr (pre_lookup_optimizer.cc:66-123):
    comparison leaves against scalar Consts, combined with
    LogicalAnd/Or/Not.  Returns None for unsupported shapes."""
    from recom_tpu_torch.ir.intervals import compare_to_interval

    n = gi.node(name)
    if n is None:
        return None
    if n.op == "LogicalAnd":
        a = _pred_to_intervals(gi, n.inputs[0])
        b = _pred_to_intervals(gi, n.inputs[1])
        return a.intersect(b) if a is not None and b is not None else None
    if n.op == "LogicalOr":
        a = _pred_to_intervals(gi, n.inputs[0])
        b = _pred_to_intervals(gi, n.inputs[1])
        return a.union(b) if a is not None and b is not None else None
    if n.op == "LogicalNot":
        a = _pred_to_intervals(gi, n.inputs[0])
        return a.complement() if a is not None else None
    if n.op in _CMP_OPS:
        sym = _CMP_OPS[n.op]
        rhs = _cmp_const(gi, n.inputs[1])
        if rhs is None:
            lhs = _cmp_const(gi, n.inputs[0])
            if lhs is None:
                return None
            sym, rhs = _CMP_MIRROR[sym], lhs
        return _cmp_interval_numeric(sym, rhs)
    return None


def _cmp_const(gi: GraphIndex, name: str):
    """Comparison-operand constant, resolving through plumbing incl. Cast
    — real feature-column graphs wrap the bounds in Cast(Const) (identity
    column's zero/num_buckets, feature_column_v2).  Only INTEGRAL values
    resolve through a Cast: a fractional const's cast result depends on
    the target dtype the plumbing-resolution discards."""
    c = _const_scalar(gi, name)
    if c is not None:
        return c
    t = _const_tensor_through(gi, name)
    if t is None or t.size != 1:
        return None
    v = t.reshape(()).item()
    if isinstance(v, (bytes, str)):
        return v
    return v if float(int(v)) == float(v) else None


def _cmp_interval_numeric(sym: str, rhs):
    """compare_to_interval over integer ids with a possibly-FRACTIONAL
    comparison constant: x < 2.5 over ints means x <= 2, x > -0.5 means
    x >= 0, x == 2.5 is empty.  int() truncation toward zero would get all
    of these wrong for non-integral rhs."""
    import math

    from recom_tpu_torch.ir.intervals import IntervalSet, compare_to_interval

    if isinstance(rhs, (bytes, str)):
        return None     # string predicate (e.g. the to_sparse_input
                        # missing-value filter) — not an id-range filter
    r = float(rhs)
    if float(int(r)) == r:
        return compare_to_interval(sym, int(r))
    if sym == "<":
        return IntervalSet.le(math.floor(r))
    if sym == "<=":
        return IntervalSet.le(math.floor(r))
    if sym == ">":
        return IntervalSet.ge(math.ceil(r))
    if sym == ">=":
        return IntervalSet.ge(math.ceil(r))
    if sym == "==":
        return IntervalSet.empty()
    if sym == "!=":
        return IntervalSet.all()
    return None


_PASS_OPS = ("Identity", "Reshape", "Squeeze", "ExpandDims", "Cast")


def _resolve_through(
    gi: GraphIndex, name: str, ops: Tuple[str, ...] = _PASS_OPS
) -> Optional[Node]:
    """Walk backward through shape/dtype-only ops to the producing node."""
    n = gi.node(name)
    seen = set()
    while n is not None and n.op in ops and n.inputs:
        if n.name in seen:
            return None
        seen.add(n.name)
        n = gi.node(n.inputs[0])
    return n


def _const_tensor_through(gi: GraphIndex, name: str) -> Optional[np.ndarray]:
    n = _resolve_through(gi, name)
    if n is None or n.op != "Const":
        return None
    return attr_tensor(n.attr("value"))


def _extract_range_transforms(
    gi: GraphIndex, sub, warnings: Optional[List[str]] = None
) -> tuple:
    """(transform, subject placeholder name) pairs for the column
    subgraph's Where+Gather (value filtering) and Select (substitution)
    idioms — the patterns the reference's PreLookupOptimizer matches and
    rewrites into its Gather*/SelectValue custom ops
    (pre_lookup_optimizer.cc:25-123).  Gather indices are traced back
    through Reshape/Squeeze/Cast to their Where (real frozen graphs insert
    shape plumbing between the two).

    The SUBJECT (the placeholder the predicate's data operand reaches)
    matters: a weighted column's weight plane carries its own
    dense-to-sparse NotEqual(w, 0) filter, and importing that interval as
    an ID filter silently zeroes rows whose id happens to equal the
    ignore value (found by the import fuzzer: an id hashing to bucket 0
    vanished).  Callers keep only pairs whose subject is the id feed
    (_range_for)."""
    from recom_tpu_torch.ir.intervals import IntervalSet
    from recom_tpu_torch.ir.spec import FilterRange, FilterStrSentinel, SelectRange

    order = gi.order
    found = []
    has_gather_of = set()
    for x in sub:
        if x.op in (
            "GatherV2", "Gather", "GatherNd", "ResourceGather"
        ) and len(x.inputs) > 1:
            src = _resolve_through(gi, x.inputs[1])
            if src is not None:
                has_gather_of.add(src.name)

    def subject(pred_name: str) -> Optional[str]:
        ph = _placeholder_of(gi, pred_name)
        return ph.name if ph is not None else None

    for x in sorted(sub, key=lambda s: order.get(id(s), 0)):
        if x.op == "Where":
            sent = _str_sentinel_pred(gi, x.inputs[0])
            if sent is not None and x.name in has_gather_of:
                # string-plane filter: keep values != sentinel BEFORE the
                # string->id transform (the reference's
                # Addons>GatherStrValueGenIndice,
                # gather_str_value_gen_indice_ops.cc:31-58).  The EMPTY
                # sentinel is the to_sparse_input missing-value drop whose
                # observable semantics the source materialization already
                # carries (validated bit-exact vs TF); only non-empty
                # sentinels import as an explicit transform.
                found.append(
                    (FilterStrSentinel(sent), subject(x.inputs[0]))
                )
                continue
            iv = _pred_to_intervals(gi, x.inputs[0])
            if iv is None or iv.is_all():
                continue
            if x.name in has_gather_of:
                found.append((FilterRange(iv), subject(x.inputs[0])))
            elif warnings is not None:
                warnings.append(
                    f"filter idiom at {x.name}: predicate compiles to "
                    f"{iv} but no Gather consumes the Where indices; "
                    "filter NOT imported"
                )
        elif x.op in ("Select", "SelectV2"):
            iv = _pred_to_intervals(gi, x.inputs[0])
            if iv is None:
                continue
            sub_val = _const_scalar(gi, x.inputs[2])
            if sub_val is not None and not iv.is_all():
                # select(cond, VALUES, const): keep the cond-true interval
                found.append(
                    (SelectRange(iv, int(sub_val)), subject(x.inputs[0]))
                )
                continue
            # the MIRRORED order — where(out_of_range, fill(default),
            # VALUES) — is what categorical_column_with_identity's
            # default_value emits (feature_column_v2's out-of-range
            # patch-up): keep the cond-FALSE interval
            sub_val = _splat_scalar(gi, x.inputs[1])
            if sub_val is not None and not iv.is_empty():
                found.append(
                    (SelectRange(iv.complement(), int(sub_val)),
                     subject(x.inputs[0]))
                )
    return tuple(found)


def _str_sentinel_pred(gi: GraphIndex, name: str) -> Optional[str]:
    """NON-EMPTY string sentinel of a ``NotEqual(values, const_str)``
    predicate (either operand order), else None.  The string-plane filter
    idiom the reference serves with Addons>GatherStrValueGenIndice
    (gather_str_value_gen_indice_ops.cc:31-58)."""
    n = gi.node(name)
    if n is None or n.op != "NotEqual" or len(n.inputs) < 2:
        return None
    for operand in (n.inputs[1], n.inputs[0]):
        c = _resolve_through(gi, operand)
        if c is None or c.op != "Const":
            continue
        s = _const_string(gi, c.name)
        if s is None:
            sc = _cmp_const(gi, c.name)
            if isinstance(sc, (bytes, str)):
                s = sc.decode() if isinstance(sc, bytes) else sc
        if s:
            return s
    return None


def _range_for(pairs, main_ph, warnings: List[str]) -> tuple:
    """Range transforms whose predicate subject IS the id feed.  A known
    subject differing from the id placeholder belongs to another plane
    (the weight feed's missing-value filter) and must not rewrite ids;
    an UNKNOWN subject (no placeholder reachable — fully-frozen operand)
    is kept, matching the pre-fuzzer behavior for hand-built graphs."""
    out = []
    for t, subj in pairs:
        if (
            subj is not None and main_ph is not None
            and subj != main_ph.name
        ):
            warnings.append(
                f"range idiom over {subj!r} is not on the id value path "
                f"({main_ph.name!r}); NOT imported as an id transform"
            )
            continue
        out.append(t)
    return tuple(out)


def _splat_scalar(gi: GraphIndex, name: str):
    """Scalar value of a constant splat: a Const scalar or a
    Fill(shape, const) — the shapes TF uses to broadcast a default."""
    n = _resolve_through(gi, name)
    if n is None:
        return None
    if n.op == "Const":
        return _const_scalar(gi, n.name)
    if n.op == "Fill" and len(n.inputs) > 1:
        return _cmp_const(gi, n.inputs[1])  # Fill value may be Cast(Const)
    return None


def _peel_value_selects(gi: GraphIndex, name: str) -> str:
    """Step through Select/SelectV2 nodes on the id value path whose
    predicate + splat compile to a SelectRange (extracted separately by
    _extract_range_transforms), following the VALUE branch — so the
    identity-with-default idiom's value path still traces to its
    Placeholder."""
    cur = name
    for _ in range(4):
        n = _trace_value_source(gi, cur)
        if (
            n is None or n.op not in ("Select", "SelectV2")
            or len(n.inputs) < 3
            or _pred_to_intervals(gi, n.inputs[0]) is None
        ):
            return cur
        if _const_scalar(gi, n.inputs[2]) is not None:
            cur = n.inputs[1]
        elif _splat_scalar(gi, n.inputs[1]) is not None:
            cur = n.inputs[2]
        else:
            return cur
    return cur


def _vocab_transform(gi: GraphIndex, ops: Dict, warnings: List[str]):
    """Recognize the TF vocabulary-column idiom: HashTableV2 +
    LookupTableFindV2 with keys/values from the table's Import/Initialize
    op; OOV buckets via StringToHashBucketFast(num_oov) + size offset +
    Select (tf.lookup IdTableWithHashBuckets).  Returns
    (VocabLookup, keys_are_int) or (None, None).

    Reference analogue: lookup chains the reference leaves on CPU
    (cuda_emitter.cc SetFCBeginToCPU pins table producers to host); here
    they become a host-side VocabLookup transform."""
    from recom_tpu_torch.ir.spec import VocabLookup

    find = ops.get("LookupTableFindV2") or ops.get("LookupTableFind")
    if find is None or len(find.inputs) < 3:
        return None, None
    tbl = _resolve_through(gi, find.inputs[0], ("Identity",))
    if tbl is None:
        return None, None
    imp = None
    for n in gi.nodes:
        if (
            n.op in ("LookupTableImportV2", "InitializeTableV2",
                     "LookupTableImport", "InitializeTable")
            and n.inputs
            and _resolve_through(gi, n.inputs[0], ("Identity",)) is tbl
        ):
            imp = n
            break
    if imp is None or len(imp.inputs) < 3:
        warnings.append(
            f"vocab table {tbl.name}: no Import/Initialize op with frozen "
            "keys/values in graph; column NOT imported as vocab"
        )
        return None, None
    keys = _const_tensor_through(gi, imp.inputs[1])
    vals = _const_tensor_through(gi, imp.inputs[2])
    if keys is None:
        warnings.append(
            f"vocab table {tbl.name}: keys are not a frozen Const "
            "(vocabulary_file without embedded vocab?); NOT imported"
        )
        return None, None
    keys_flat = keys.reshape(-1)
    if keys_flat.size == 0:
        warnings.append(
            f"vocab table {tbl.name}: empty vocabulary tensor; NOT "
            "imported as vocab"
        )
        return None, None
    keys_are_int = not isinstance(keys_flat[0], (bytes, np.bytes_, str))
    key_list = [
        int(k) if keys_are_int
        else (k.decode() if isinstance(k, (bytes, np.bytes_)) else str(k))
        for k in keys_flat
    ]
    if vals is None and _is_iota(gi, imp.inputs[2], len(key_list)):
        # vocabulary_list emits values = Cast(Range(0, Size(keys), 1)) —
        # a PROVABLE identity mapping, not a frozen Const
        vals = np.arange(len(key_list))
    if vals is None or vals.size != len(key_list):
        # assuming identity key->id values when the Import op's values
        # are neither frozen nor a provable iota would silently mis-map
        # EVERY id if the real values were a permutation or offset
        warnings.append(
            f"vocab table {tbl.name}: id values are not a frozen Const "
            "(or Range iota) aligned with the keys; NOT imported as vocab"
        )
        return None, None
    vocab: List = key_list
    v = np.asarray(vals).reshape(-1).astype(np.int64)
    if not np.array_equal(v, np.arange(len(key_list))):
        slots: List = [None] * len(key_list)
        for k, i in zip(key_list, v):
            i = int(i)
            if not (0 <= i < len(slots)) or slots[i] is not None:
                warnings.append(
                    f"vocab table {tbl.name}: non-bijective id values; "
                    "NOT imported as vocab"
                )
                return None, None
            slots[i] = k
        vocab = slots
    default = _cmp_const(gi, find.inputs[2])    # resolves Cast(Const)
    if default is None or isinstance(default, (bytes, str)):
        # a computed default would be silently replaced by -1
        warnings.append(
            f"vocab table {tbl.name}: default value is not a frozen "
            "scalar Const; NOT imported as vocab"
        )
        return None, None
    default = int(default)
    num_oov = 0
    sth = ops.get("StringToHashBucketFast")
    if sth is not None and (
        "LookupTableSizeV2" in ops or "AddV2" in ops or "Add" in ops
    ):
        num_oov = attr_int(sth.attr("num_buckets")) or 0
    return VocabLookup(vocab, num_oov=num_oov, default=default), keys_are_int


# Ops a raw feature VALUE passes through unchanged on its way to a
# transform anchor (Bucketize/Hash/LookupTableFind) in TF's feature-column
# expansion: shape/dtype plumbing, the to_sparse_input missing-value
# filter (values ride the gather's params side; selection never edits the
# surviving values), string splitting (pieces of the source), and the
# empty-row default insertion.  Value is the FIRST input except where
# noted.  Anything else between the placeholder and the anchor computes —
# importing would silently drop it (the ADVICE r02 Mul(2.0) case).
_VALUE_TRAVERSAL: Dict[str, int] = {
    "Identity": 0, "Reshape": 0, "Squeeze": 0, "ExpandDims": 0,
    "Cast": 0, "AsString": 0,
    "GatherNd": 0, "GatherV2": 0,
    "StringSplit": 0, "StringSplitV2": 0,
    "SparseFillEmptyRows": 1,      # (indices, VALUES, shape, default)
    "SparseToDense": 2,            # (indices, shape, VALUES, default)
}


# Elementwise ops with a constant operand compilable to a HostEvalChain
# step (the reference's MatchExpr / op_infer_fn vocabulary,
# pre_lookup_optimizer.cc:66-123): op name -> (step op, mirrored step op
# when the CONST is the left operand; None = bail on const-left).
_HOSTEVAL_BINOPS = {
    "Mul": ("mul", "mul"),
    "Add": ("add", "add"),
    "AddV2": ("add", "add"),
    "Sub": ("sub", "rsub"),
    "RealDiv": ("div", "rdiv"),
    "Div": ("div", "rdiv"),
    "FloorDiv": ("floordiv", None),
    "FloorMod": ("mod", None),
    "Maximum": ("maximum", "maximum"),
    "Minimum": ("minimum", "minimum"),
}
_HOSTEVAL_UNOPS = {"Floor": "floor", "Ceil": "ceil", "Round": "round"}
_EVAL_DT = {DT_FLOAT: "f32", DT_DOUBLE: "f64", DT_INT32: "i32",
            DT_INT64: "i64"}


def _compile_host_eval(gi: GraphIndex, name: str):
    """Compile the value path from ``name`` back to a Placeholder into
    HostEvalChain steps (forward order), traversing value-preserving ops
    and elementwise const-operand arithmetic.  Returns (steps, placeholder)
    or (None, None) when the segment contains anything else — the caller
    then falls back to strict raise / warn."""
    steps_rev = []
    n = gi.node(name)
    seen: Set[str] = set()
    while n is not None and n.name not in seen:
        seen.add(n.name)
        if n.op == "Placeholder":
            if not steps_rev:
                return None, None       # nothing to evaluate
            return tuple(reversed(steps_rev)), n
        if n.op == "Cast":
            dt = _EVAL_DT.get(attr_type(n.attr("DstT")))
            if dt is None:
                return None, None
            steps_rev.append(("cast", None, dt))
            n = gi.node(n.inputs[0])
            continue
        if n.op in _VALUE_TRAVERSAL:
            idx = _VALUE_TRAVERSAL[n.op]
            if idx >= len(n.inputs):
                return None, None
            n = gi.node(n.inputs[idx])
            continue
        dt = _EVAL_DT.get(attr_type(n.attr("T")))
        if n.op in _HOSTEVAL_UNOPS and dt is not None and n.inputs:
            steps_rev.append((_HOSTEVAL_UNOPS[n.op], None, dt))
            n = gi.node(n.inputs[0])
            continue
        if n.op in _HOSTEVAL_BINOPS and dt is not None and len(n.inputs) >= 2:
            op_r, op_l = _HOSTEVAL_BINOPS[n.op]
            # keep the RAW const (int for i32/i64 steps): float() here
            # would corrupt int64 constants above 2^53 before
            # HostEvalChain's dtype-aware coercion ever sees them
            c = _const_scalar(gi, n.inputs[1])
            if c is not None:
                steps_rev.append((op_r, c, dt))
                n = gi.node(n.inputs[0])
                continue
            c = _const_scalar(gi, n.inputs[0])
            if c is not None and op_l is not None:
                steps_rev.append((op_l, c, dt))
                n = gi.node(n.inputs[1])
                continue
        return None, None
    return None, None


def _is_iota(gi: GraphIndex, name: str, n: int) -> bool:
    """True when the tensor is provably [0, 1, ..., n-1]: a Range with
    start 0, delta 1, and limit either the const n or Size(<n-element
    Const>) — the shape vocabulary_list uses for its table values."""
    node = _resolve_through(gi, name)       # through the Cast
    if node is None or node.op != "Range" or len(node.inputs) < 3:
        return False
    if _cmp_const(gi, node.inputs[0]) != 0:
        return False
    if _cmp_const(gi, node.inputs[2]) != 1:
        return False
    limit = _cmp_const(gi, node.inputs[1])
    if limit is not None:
        return int(limit) == n
    sz = _resolve_through(gi, node.inputs[1])
    if sz is not None and sz.op == "Size" and sz.inputs:
        t = _const_tensor_through(gi, sz.inputs[0])
        return t is not None and t.size == n
    return False


def _split_delimiter(gi: GraphIndex, sp) -> Optional[str]:
    """Single-byte delimiter of a StringSplit[V2] node, or None when the
    split mode has no single-byte wire form.  StringSplit (v1) defaults to
    " " and treats "" as per-CHARACTER splitting; StringSplitV2 treats an
    empty/absent sep as whitespace-RUN splitting.  The old `or ";"`
    fallback silently substituted ';' for all of these, changing ids."""
    raw = _const_string(gi, sp.inputs[1]) if len(sp.inputs) > 1 else None
    if sp.op == "StringSplit" and raw is None:
        raw = " "                       # v1 default delimiter
    if raw is not None and len(raw) == 1:
        return raw
    return None


def _split_delim_on_path(gi: GraphIndex, name: str) -> Optional[str]:
    """Delimiter of the first StringSplit on the value path from ``name``
    back toward its source, or None when the path has no split."""
    node = gi.node(name)
    seen: Set[str] = set()
    while node is not None and node.name not in seen:
        seen.add(node.name)
        if node.op in ("StringSplit", "StringSplitV2"):
            # "" (unsupported split mode) is distinct from None (no split
            # on the path): callers comparing weight-plane delimiters must
            # see the mismatch, not an invented ';'
            return _split_delimiter(gi, node) or ""
        if node.op not in _VALUE_TRAVERSAL or not node.inputs:
            return None
        idx = _VALUE_TRAVERSAL[node.op]
        if idx >= len(node.inputs):
            return None
        node = gi.node(node.inputs[idx])
    return None


def _delimited_weight_plane(
    gi: GraphIndex, sub, main_ph, id_delim, warnings: List[str]
) -> Optional[str]:
    """Weight feed shipped as a second delimited string: find a sparse
    plane in the slot whose values are StringToNumber(float) of a
    StringSplit of a STRING placeholder other than the id feature.  The
    engine parses the weight strings with the ID field's delimiter (one
    wire convention per column): a mismatched split delimiter — or an id
    feed that is not itself a delimited list — bails."""
    if id_delim is None:
        # a non-delimited id feed pairs 1:1 with SCALAR weights; a
        # delimited multi-score plane cannot align with it
        return None
    for x in sub:
        if x.op != "SparseFillEmptyRows" or len(x.inputs) < 2:
            continue
        stop = _trace_value_source(gi, x.inputs[1])
        if (
            stop is not None and stop.op == "SparseSoftmax"
            and len(stop.inputs) > 1
        ):
            # the softmax rewrites the scores in-graph; the engine
            # re-applies it from the RAW feed (Combiner.SOFTMAX), so
            # trace on through the op's values input
            stop = _trace_value_source(gi, stop.inputs[1])
        if stop is None or stop.op != "StringToNumber" or not stop.inputs:
            continue
        ot = attr_type(stop.attr("out_type"))
        if ot not in (DT_FLOAT, DT_DOUBLE, None):   # absent attr = f32
            continue
        src = _trace_value_source(gi, stop.inputs[0])
        if (
            src is None or src.op != "Placeholder"
            or attr_type(src.attr("dtype")) != DT_STRING
            or (main_ph is not None and src.name == main_ph.name)
        ):
            continue
        # the split between the placeholder and the parse must use the
        # id chain's delimiter
        w_delim = _split_delim_on_path(gi, stop.inputs[0])
        if w_delim is not None and w_delim != id_delim:
            warnings.append(
                f"weight plane {src.name}: split delimiter {w_delim!r} "
                f"differs from the id feed's {id_delim!r}; weights NOT "
                "imported (one delimiter per column on the wire)"
            )
            continue
        return src.name
    return None


_POOLED_PASS = ("Identity", "Reshape", "ExpandDims", "Squeeze")
_POOLED_TERMINALS = frozenset({
    "SparseSegmentSum", "SparseSegmentMean", "SparseSegmentSqrtN",
    "SparseSegmentSumWithNumSegments", "SparseSegmentMeanWithNumSegments",
    "SparseSegmentSqrtNWithNumSegments", "GatherV2", "GatherNd",
    "ResourceGather", "OneHot",
})
_POOLED_TERMINALS_WEIGHTED = _POOLED_TERMINALS | frozenset({
    # the weighted embedding_lookup_sparse expansion's own tail ops
    "SegmentSum", "DivNoNan", "RealDiv", "Div",
})


def _verify_pooled_path(gi: GraphIndex, name: str, weighted: bool = False):
    """Walk the POOLED value path from a slot's (post-peeled) frontier back
    to the lookup/pooling op through value-preserving plumbing only.
    Returns None when the path is clean, else the first computing node on
    it: compute between the pooled lookup and the concat is modeled by
    neither the combiner nor the PostPool chain and would be silently
    dropped.  This is the pooled-path analogue of _trace_value_source's
    pre-anchor check (the reference's RETURN_IF_FALSE discipline leaves
    such graphs untouched rather than mis-emitting them,
    fc_optimizer_base.h:202-257)."""
    term = _POOLED_TERMINALS_WEIGHTED if weighted else _POOLED_TERMINALS
    n = gi.node(name)
    seen: Set[str] = set()
    while n is not None:
        if n.name in seen:
            return n
        seen.add(n.name)
        if n.op in term:
            return None
        if n.op in _POOLED_PASS and n.inputs:
            n = gi.node(n.inputs[0])
            continue
        if n.op in ("Select", "SelectV2") and len(n.inputs) >= 3:
            # safe_embedding empty-row patch-up: where(is_empty, zeros,
            # pooled), either arg order.  The NON-pooling branch must be a
            # zeros splat — accepting "either branch reaches pooling"
            # alone would bless where(cond, pooled, Mul(pooled, 2)) and
            # silently drop the Mul on cond-false rows
            r1 = _verify_pooled_path(gi, n.inputs[1], weighted)
            r2 = _verify_pooled_path(gi, n.inputs[2], weighted)
            if r1 is None and r2 is None:
                return None
            if r2 is None and _is_zeros_splat(gi, n.inputs[1]):
                return None
            if r1 is None and _is_zeros_splat(gi, n.inputs[2]):
                return None
            return n if (r1 is None or r2 is None) else (r1 or r2)
        return n
    return None      # dangling reference: nothing provably dropped


def _is_zeros_splat(gi: GraphIndex, name: str) -> bool:
    """True when the tensor is provably all-zero (ZerosLike, Fill(0), or
    an all-zero Const) — the empty-row patch-up's replacement branch."""
    n = _resolve_through(gi, name)
    if n is None:
        return False
    if n.op == "ZerosLike":
        return True
    if n.op == "Fill" and len(n.inputs) > 1:
        return _cmp_const(gi, n.inputs[1]) == 0
    if n.op == "Const":
        t = attr_tensor(n.attr("value"))
        return t is not None and not np.any(t)
    return False


def _trace_value_source(gi: GraphIndex, name: str) -> Optional[Node]:
    """Walk backward from ``name`` through value-preserving ops to the
    producing node.  A clean feature chain ends at a Placeholder; any
    computing op (Mul, AddV2, a second transform, ...) is returned
    instead, so callers can refuse the import under strict mode rather
    than silently dropping it."""
    n = gi.node(name)
    seen: Set[str] = set()
    while n is not None and n.op in _VALUE_TRAVERSAL and n.inputs:
        if n.name in seen:
            return None
        seen.add(n.name)
        idx = _VALUE_TRAVERSAL[n.op]
        if idx >= len(n.inputs):
            return n
        n = gi.node(n.inputs[idx])
    return n


# Op vocabulary of REAL frozen tf.feature_column slots (measured over
# input_layer graphs built by TF 2.21 for every idiom this importer
# claims: bucketized / hash / vocabulary-list (OOV, default_value, int
# keys) / weighted / indicator / identity / crossed / split — see
# tests/test_tf_import_real.py).  A slot containing ops OUTSIDE its
# idiom's vocabulary carries computation this importer does not model;
# strict mode refuses it.  (Presence alone is necessary, not sufficient —
# Mul/AddV2 legitimately appear as offset math — which is why
# _trace_value_source above independently verifies the value path.)
_SLOT_OPS_COMMON = frozenset({
    "Placeholder", "Const", "Identity", "Reshape", "Cast", "ExpandDims",
    "Squeeze", "Pack", "Shape", "Slice", "StridedSlice", "Prod", "Range",
    "Tile", "Transpose", "ConcatV2", "Concat", "Where", "Select",
    "SelectV2", "GatherV2", "GatherNd", "ResourceGather", "Greater",
    "GreaterEqual", "Less",
    "LessEqual", "Equal", "NotEqual", "LogicalAnd", "LogicalOr",
    "LogicalNot", "SparseFillEmptyRows", "SparseReshape", "Unique",
    "ZerosLike", "Fill", "Sub", "Mul", "Add", "AddV2", "Maximum", "Size",
    "Rank", "SparseSegmentMean", "SparseSegmentSum", "SparseSegmentSqrtN",
    "SparseSegmentSumWithNumSegments", "SparseSegmentMeanWithNumSegments",
    "SparseSegmentSqrtNWithNumSegments",
    "Sum", "Mean", "VariableV2", "VarHandleOp", "ReadVariableOp", "NoOp",
    "StringSplit", "StringSplitV2", "SparseToDense",
})
_SLOT_OPS_BY_ANCHOR = {
    "bucketize": frozenset({"Bucketize"}),
    "hash": frozenset({"StringToHashBucketFast", "AsString",
                       "StringToNumber"}),
    "vocab": frozenset({
        "LookupTableFindV2", "LookupTableFind", "HashTableV2",
        "LookupTableSizeV2", "LookupTableImportV2", "InitializeTableV2",
        "LookupTableImport", "InitializeTable",
        "StringToHashBucketFast", "AsString",  # OOV bucket hashing
    }),
    "identity": frozenset({"StringToNumber"}),   # delimited int-list parse
}
_SLOT_OPS_WEIGHTED = frozenset({
    "SegmentSum", "DivNoNan", "RealDiv", "Div", "Sqrt", "Square", "Pow",
    "SparseSoftmax",
})
_SLOT_OPS_INDICATOR = frozenset({"OneHot"})


def _slot_residue(
    ops_present: Set[str], anchor_kind: str,
    weighted: bool = False, indicator: bool = False,
    hosteval: frozenset = frozenset(),
) -> Set[str]:
    """Ops in the slot outside its idiom's measured vocabulary (empty for
    every real feature-column graph; non-empty = unmodeled computation)."""
    allowed = _SLOT_OPS_COMMON | _SLOT_OPS_BY_ANCHOR.get(
        anchor_kind, frozenset()
    )
    if weighted:
        allowed = allowed | _SLOT_OPS_WEIGHTED
    if indicator:
        allowed = allowed | _SLOT_OPS_INDICATOR
    if hosteval:
        # only the TF ops the column's HostEvalChain actually absorbed
        allowed = allowed | hosteval
    return set(ops_present) - allowed


def _placeholder_of(gi: GraphIndex, name: str):
    """First Placeholder reachable backward from ``name`` (depth-first in
    input order), or None."""
    n = gi.node(name)
    seen = set()
    stack = [n] if n is not None else []
    while stack:
        x = stack.pop(0)
        if x.name in seen:
            continue
        seen.add(x.name)
        if x.op == "Placeholder":
            return x
        for i in x.inputs:
            nn = gi.node(i)
            if nn is not None:
                stack.append(nn)
    return None


def _const_string(gi: GraphIndex, name: str) -> Optional[str]:
    n = gi.node(name)
    if n is None or n.op != "Const":
        return None
    raw = n.attr("value")
    if raw is None:
        return None
    d = pw.fields_dict(raw)
    if 8 not in d:
        return None
    t = pw.fields_dict(d[8][0])
    sv = t.get(8, [])
    if sv:
        return sv[0].decode()
    return None

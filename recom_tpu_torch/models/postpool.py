"""Small models with post-lookup (PostPool) ops: the three of the JAX
package's tests/test_postlookup.py, and one with every post op and hidden
operands in a one-hot and in a gather group.

Each factory takes the spec module to build with, by default this
package's ``recom_tpu_torch.ir.spec``; any module with the same classes
builds the same model (the parity tests build the JAX package's twin from
its own spec module).
"""

from __future__ import annotations

import numpy as np

from recom_tpu_torch.ir import spec


def make_post_model(S=spec):
    """tests/test_postlookup.py::make_post_model: reduce_sum on a one-hot
    bucketize member, affine then reduce_mean, a per-dim affine on a
    ragged column, and a plain member beside them."""
    K, C, P = S.FeatureKind, S.Combiner, S.PostPool
    tables = {
        "t_bz": S.TableSpec("t_bz", 11, 8),
        "t_h": S.TableSpec("t_h", 500, 8),
        "t_sp": S.TableSpec("t_sp", 300, 8),
        "t_keep": S.TableSpec("t_keep", 64, 4),
    }
    cols = [
        S.FeatureColumn("rb", S.FeatureSource("rb", K.DENSE_FLOAT),
                        (S.Bucketize(list(range(0, 50, 5))),),
                        S.LookupSpec("t_bz", C.MEAN),
                        post=(P("reduce_sum"),)),
        S.FeatureColumn("rh", S.FeatureSource("rh", K.STRING),
                        (S.HashBucket(500),), S.LookupSpec("t_h", C.MEAN),
                        post=(P("affine", scale=(2.0,), bias=(0.5,)),
                              P("reduce_mean"))),
        S.FeatureColumn("ra", S.FeatureSource("ra", K.STRING_LIST,
                                              delimiter=";"),
                        (S.HashBucket(300),), S.LookupSpec("t_sp", C.SUM),
                        post=(P("affine", scale=tuple(
                            float(i + 1) for i in range(8))),)),
        S.FeatureColumn("keep", S.FeatureSource("keep", K.STRING),
                        (S.HashBucket(64),), S.LookupSpec("t_keep", C.MEAN)),
        S.FeatureColumn("d0", S.FeatureSource("d0", K.DENSE_FLOAT)),
    ]
    tower = S.TowerSpec(arch="mlp", bottom_mlp=(), top_mlp=(8, 1),
                        final_activation=None)
    return S.ModelSpec("post", tables, cols, tower)


def make_softmax_mul_model(S=spec):
    """tests/test_postlookup.py::make_softmax_mul_model: mul_column with a
    HIDDEN operand, a cross-group mul_column, and softmax."""
    K, C, P = S.FeatureKind, S.Combiner, S.PostPool
    tables = {
        "t_a": S.TableSpec("t_a", 200, 8),
        "t_b": S.TableSpec("t_b", 300, 8),
        "t_sp": S.TableSpec("t_sp", 150, 8),
        "t_sm": S.TableSpec("t_sm", 64, 4),
    }
    cols = [
        S.FeatureColumn("a", S.FeatureSource("a", K.STRING),
                        (S.HashBucket(200),), S.LookupSpec("t_a", C.MEAN),
                        post=(P("mul_column", other="b_hidden"),)),
        S.FeatureColumn("b_hidden", S.FeatureSource("bh", K.STRING),
                        (S.HashBucket(300),), S.LookupSpec("t_b", C.SUM),
                        in_concat=False),
        S.FeatureColumn("sp", S.FeatureSource("sp", K.STRING_LIST,
                                              delimiter=";"),
                        (S.HashBucket(150),), S.LookupSpec("t_sp", C.SUM),
                        post=(P("mul_column", other="a"),)),
        S.FeatureColumn("sm", S.FeatureSource("sm", K.STRING),
                        (S.HashBucket(64),), S.LookupSpec("t_sm", C.MEAN),
                        post=(P("softmax"),)),
        S.FeatureColumn("d0", S.FeatureSource("d0", K.DENSE_FLOAT)),
    ]
    tower = S.TowerSpec(arch="mlp", bottom_mlp=(), top_mlp=(8, 1),
                        final_activation=None)
    return S.ModelSpec("postsm", tables, cols, tower)


def make_matmul_model(S=spec):
    """tests/test_postlookup.py's matmul chain: a plain 8 -> 5 projection,
    and softmax -> 4 -> 3 projection -> reduce_sum."""
    K, C, P = S.FeatureKind, S.Combiner, S.PostPool
    rng = np.random.default_rng(12)
    w_85 = tuple(tuple(rng.uniform(-1, 1, 5)) for _ in range(8))
    w_43 = tuple(tuple(rng.uniform(-1, 1, 3)) for _ in range(4))
    tables = {"t8": S.TableSpec("t8", 100, 8), "t4": S.TableSpec("t4", 40, 4)}
    cols = [
        S.FeatureColumn("pa", S.FeatureSource("pa", K.STRING),
                        (S.HashBucket(100),), S.LookupSpec("t8", C.MEAN),
                        post=(P("matmul", weight=w_85),)),
        S.FeatureColumn("pb", S.FeatureSource("pb", K.STRING),
                        (S.HashBucket(40),), S.LookupSpec("t4", C.SUM),
                        post=(P("softmax"), P("matmul", weight=w_43),
                              P("reduce_sum"))),
        S.FeatureColumn("d0", S.FeatureSource("d0", K.DENSE_FLOAT)),
    ]
    return S.ModelSpec("pm", tables, cols,
                       S.TowerSpec(arch="mlp", top_mlp=(8, 1)))


def make_every_post_model(S=spec):
    """Every post op, and hidden operands in a one-hot group (vocab 300)
    and in a gather group (vocab 6000), each reaching the concat only
    through a mul_column across groups; a bottom MLP on two dense
    inputs."""
    K, C, P = S.FeatureKind, S.Combiner, S.PostPool
    rng = np.random.default_rng(5)
    w_86 = tuple(tuple(rng.uniform(-1, 1, 6)) for _ in range(8))
    tables = {
        "t_a": S.TableSpec("t_a", 200, 8),
        "t_ho": S.TableSpec("t_ho", 300, 8),
        "t_hg": S.TableSpec("t_hg", 6000, 8),
        "t_sp": S.TableSpec("t_sp", 150, 8),
        "t_bz": S.TableSpec("t_bz", 11, 4),
    }
    bz = S.Bucketize(list(range(0, 50, 5)))
    cols = [
        S.FeatureColumn("a", S.FeatureSource("a", K.STRING),
                        (S.HashBucket(200),), S.LookupSpec("t_a", C.MEAN),
                        post=(P("mul_column", other="h_gather"),
                              P("affine", scale=tuple(
                                  0.5 + 0.25 * i for i in range(8)),
                                bias=(0.1,)))),
        S.FeatureColumn("h_onehot", S.FeatureSource("ho", K.STRING),
                        (S.HashBucket(300),), S.LookupSpec("t_ho", C.SUM),
                        in_concat=False),
        S.FeatureColumn("h_gather", S.FeatureSource("hg", K.STRING),
                        (S.HashBucket(6000),), S.LookupSpec("t_hg", C.SUM),
                        in_concat=False),
        S.FeatureColumn("sp", S.FeatureSource("sp", K.STRING_LIST,
                                              delimiter=";"),
                        (S.HashBucket(150),), S.LookupSpec("t_sp", C.MEAN),
                        post=(P("mul_column", other="h_onehot"),
                              P("softmax"), P("matmul", weight=w_86))),
        S.FeatureColumn("r", S.FeatureSource("r", K.DENSE_FLOAT), (bz,),
                        S.LookupSpec("t_bz", C.MEAN),
                        post=(P("reduce_sum"),)),
        S.FeatureColumn("m", S.FeatureSource("m", K.DENSE_FLOAT), (bz,),
                        S.LookupSpec("t_bz", C.MEAN),
                        post=(P("reduce_mean"),)),
        S.FeatureColumn("d0", S.FeatureSource("d0", K.DENSE_FLOAT)),
        S.FeatureColumn("d1", S.FeatureSource("d1", K.DENSE_FLOAT)),
    ]
    tower = S.TowerSpec(arch="mlp", bottom_mlp=(4,), top_mlp=(8, 1))
    return S.ModelSpec("every_post", tables, cols, tower)

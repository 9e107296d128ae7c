"""recom_tpu_torch: the PyTorch/CUDA port of recom_tpu, for one NVIDIA H100.

The JAX package ``recom_tpu`` beside it is the reference; this package
imports nothing of it (and never ``jax``).  The framework-neutral modules
it needs (ir, compiler, config, oracle, models, native host ops, host prep
and the host half of the wire) are its own copies, differing only in the
package name of their imports.  What runs on the device is rewritten:

  runtime/executor.py   Engine: host prep -> one H2D copy -> lookups -> tower;
                        dispatch (asynchronous, pinned copies),
                        update_table_rows, reload_params
  runtime/graphs.py     Program: one captured CUDA graph per (shape
                        signature, outputs) on the card, which every
                        request after the first replays
  runtime/server.py     ServingPipeline, throughput_under_sla
  parallel/             serving on a ("data", "model") mesh of
                        torch.distributed ranks: make_mesh, the psum path
                        (sharded_group_pooled) and the all-to-all id
                        exchange (all_to_all_group_pooled), on X1
  runtime/batcher.py    MicroBatcher (a copy)
  tools/serve_loops.py  loop_windows, on Engine.dispatch
  runtime/wire.py       unpack_blob: blob views + device string hashing
  ops/lookup_onehot.py  K1  one-id lookup of one-hot groups (Pallas _kernel)
                        K2  fused bucketize + lookup of pure-bucketize
                            one-hot groups fed raw floats (Pallas _bz_kernel)
  ops/lookup_gather.py  X1  gather + in-order pooling (lookup_xla.group_pooled)
  ops/hash_device.py    X2  split + FarmHash + mod (ops/hash_device.py)
  train.py              Trainer, optax-rule optimizers; the backward kernels
                        K3a (of K1), K3b (of K2) and X1b (of X1)
  runtime/checkpoint.py export/save/load in the JAX package's npz layout;
                        load also reads its orbax params/ (tensorstore)
  ops/quant.py          bf16 and int8 (per-row scale) table storage; K1, K2
                        and X1 read them as stored (K1-bf16, K2-bf16,
                        X1-bf16, X1-int8)
  importers/            frozen TF feature-column graphs and SavedModels ->
                        ModelSpec + weights (copies of recom_tpu/importers)
  csrc/*.cu             the kernels, built by nvcc at first use (ops/kernels.py)

Entry points run on CUDA unless the caller asks for the CPU, where every
kernel's plain PyTorch version runs instead.
"""

from recom_tpu_torch.ir.spec import (  # noqa: F401
    Bucketize,
    Cast,
    Combiner,
    CrossHash,
    FeatureColumn,
    FeatureKind,
    FeatureSource,
    FilterRange,
    FilterStrSentinel,
    HashBucket,
    IdentityTransform,
    LookupSpec,
    Mod,
    ModelSpec,
    NumToId,
    PostPool,
    SelectRange,
    TableSpec,
    TowerSpec,
    VocabLookup,
)
from recom_tpu_torch.config import EngineConfig  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # lazy (PEP 562): the spec classes and the compiler load without torch
    if name == "Engine":
        from recom_tpu_torch.runtime.executor import Engine

        return Engine
    if name == "Trainer":
        from recom_tpu_torch.train import Trainer

        return Trainer
    if name == "ServingPipeline":
        from recom_tpu_torch.runtime.server import ServingPipeline

        return ServingPipeline
    if name == "MicroBatcher":
        from recom_tpu_torch.runtime.batcher import MicroBatcher

        return MicroBatcher
    if name in ("make_mesh", "sharded_group_pooled",
                "all_to_all_group_pooled"):
        from recom_tpu_torch import parallel

        return getattr(parallel, name)
    raise AttributeError(f"module 'recom_tpu_torch' has no attribute {name!r}")

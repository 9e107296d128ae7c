"""recom_tpu_torch: the PyTorch/CUDA port of recom_tpu, for one NVIDIA H100.

The JAX package ``recom_tpu`` beside it is the reference; this package
imports nothing of it (and never ``jax``).  The framework-neutral modules
it needs (ir, compiler, config, oracle, models, native host ops, host prep
and the host half of the wire) are its own copies, differing only in the
package name of their imports.  What runs on the device is rewritten:

  runtime/executor.py   Engine: host prep -> one H2D copy -> lookups -> tower
  runtime/wire.py       unpack_blob: blob views + device string hashing
  ops/lookup_onehot.py  K1  one-id lookup of one-hot groups (Pallas _kernel)
                        K2  fused bucketize + lookup of pure-bucketize
                            one-hot groups fed raw floats (Pallas _bz_kernel)
  ops/lookup_gather.py  X1  gather + in-order pooling (lookup_xla.group_pooled)
  ops/hash_device.py    X2  split + FarmHash + mod (ops/hash_device.py)
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
    raise AttributeError(f"module 'recom_tpu_torch' has no attribute {name!r}")

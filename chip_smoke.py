#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (recom_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from recom_tpu_torch/csrc/ and serves,
through ``Engine(..., device="cuda")``, random weights from a seed:

* the post-lookup (PostPool) models: tests/test_postlookup.py's three
  (reduce_sum, affine, reduce_mean; softmax and mul_column with a hidden
  operand across groups; a matmul chain) and one with every post op and
  hidden operands in a one-hot and a gather group, each also trained one
  step;
* full-size model E (1000 embedding columns, five 2^23 x 32 tables) with
  the default ``EngineConfig()`` (kernels K1, X1, X2) and with
  ``host_bucketize=False`` (its 880 bucketize columns searched in K1's id
  read, beside the 50 int-hash ids of its one-hot group: at 512 and 2048
  and on a batch of NaN, +-inf, +-0.0, subnormal and boundary values,
  pooled ``==`` the oracle; no torch comparison in the replay);
* the microbenchmark model at 1000 columns with random boundaries (two
  pure-bucketize one-hot groups, vocab padded to 128 and 256) with
  ``host_bucketize=False`` and with ``wire_pack=False``: raw floats reach
  the card, and K2 bucketizes and looks them up in one pass.

Then it frees the serving engines and serves model E three more ways,
one engine at a time, from the same params:

* imported: ``model_graphdef`` writes model E as a frozen TF
  feature-column GraphDef (``VariableV2`` tables: shapes, no values) and
  the port's ``import_tf_graphdef`` imports it, strict; it must lower to
  model E's four groups and serve, at 512 and 2048, outputs ``==`` the
  native engine's (K1, X1, X2);
* ``EngineConfig(table_dtype="bfloat16")``: 2.68 GB of tables (K1-bf16
  once, X1-bf16 once, X2 three times a predict);
* ``EngineConfig(table_dtype="int8")``: 1.34 GB of int8 rows and 168 MB
  of row scales, every group on the gather path (X1-int8 once, X2 three
  times);

and micro-1000 with bf16 tables under ``host_bucketize=False`` (K2-bf16
twice), and holds the four stored-dtype variants against their plain
versions on edge inputs.

On the card every single-device ``Engine`` serves through one captured
CUDA graph per (shape signature, outputs) (recom_tpu_torch/runtime/
graphs.py): the first request of a signature runs the forward eagerly
(its launches count) and captures it; every later one replays it (each
replay counts the launches its graph holds), so every phase's launch
gates keep their values: the kernel nodes of each captured graph are
read back through libcuda and must be the launches its capture
recorded.  The main path's counted requests are replays, and a
``torch.profiler`` trace of one holds the kernels it ran.

Then the serving runtime and the parameter lifecycle, on model E at full
width, one engine at a time (``runtime_phases``):

* the programs (``graph_phases``), on a fresh engine: the first request
  of a signature (eager pass and capture) against a replayed one; a new
  signature arriving while a 2-worker ``ServingPipeline`` serves; the
  other batch buckets warmed from representative batches (memory after);
  at each of the 7 buckets the replay ``==`` ``Engine._forward`` run
  eagerly, as bits, on ``output``, ``concat`` and ``pooled``, on the
  capture's batch and on its rows permuted, with the eager pass's
  launches (at 2048 K1 1, X1 1, X2 3); the program count
  bounded by the buckets; pooled ``==`` the oracle through a replay; and
  ``update_table_rows`` after capture served by the next replay;

* a ``ServingPipeline(prep_workers=4, max_inflight=4)`` fed 24 distinct
  batches (8 at 512, 12 at 2048, 4 at 1500) from two submitting threads:
  each output ``==`` the same batch's sequential ``predict``, launches
  exactly K1 24, X1 24, X2 72; each row's output at batch 100, 512 and 1500
  ``==`` the same row's at 2048; a warmed ``Engine.dispatch`` under
  ``torch.cuda.set_sync_debug_mode("error")``; the pipeline's examples/s,
  p50 and p99 against sequential ``predict`` at 2048, and
  ``throughput_under_sla`` at 2048 with the SLA at four times that p50;
* ``MicroBatcher(max_delay_ms=2.0)``: 64 requests of 1-64 rows, each
  request's rows ``==`` the request served alone, in fewer flushes;
* the device forward with the tower's products on fixed 512-row chunks
  against one batched product over 64-row tiles, ``matmul`` + bias and a
  plain ``addmm``, in turns, and how many rows those gave other bits at
  batch 100, 512 and 1500 than at 2048;
* ``update_table_rows`` while a thread serves ``predict`` (every row of a
  K1 plane's table and of a string hash table, 4096 rows of a 2^23 x 32
  table with repeated ids), with f32, bf16 and int8 tables: every served
  column ``==`` the old table's or a fresh engine's on the updated params,
  the export ``==`` the stored dtype's rule, the new rows served through
  K1 / K1-bf16, X1 / X1-bf16 / X1-int8;
* ``reload_params`` of seed 1's params: outputs ``==`` a fresh engine's, no
  new program, every tensor in place; and a ``Trainer`` reloaded after a
  step steps on (its loss ``==`` a fresh Trainer's at rtol 1e-6; K3a 1,
  X1b 1 and Part 1).

Then model E on meshes of ranks that share the one card
(``mesh_phases``): the single-device engines freed, model E's seed-0
params saved once as ``.npy`` files, and worlds of 2 and 4 ranks spawned
(the ``spawn`` start method), all on ``cuda:0`` over gloo, each rank
reading only its stripe of the 2^23-row group from the ``mmap_mode="r"``
arrays.  Each layout of ``MESH_WORLDS`` (the all-to-all exchange with
one and two chunks, the latter with the 15 list and 50 string-hash groups
split by columns; the psum path; pure data parallelism; a world of 4 at
(2, 2)) serves batches of 512 and 2048 at full width in the default
config, held to the single-device Engine on the same params and batches
(pooled ``==``, or within 1e-6 under psum; outputs ``==``, where they are
not a finding and rtol 1e-4 / atol 1e-5), with each rank's launches
asserted (K1 1; X1 1, or 2 with the exchange's pool; X2 none: no wire on
a mesh).  On the main layout also an overflow forced by a capacity
factor of 0.01 (its count == the plain routing's on CPU copies of the
ids; "recompute" == the lossless output, "raise" raises on every rank),
``update_table_rows`` on a striped and a column-split table read back
through ``predict`` and ``export_params``, and X1 in its two mesh roles
(the psum partial sums, the exchange's pool) timed at 2048 and held to
its plain version, there and on edge inputs.  The device forward and each
collective's wall time are printed per rank: gloo through the host on
one shared card, no yardstick for NCCL over NVLink.

In the same worlds model E then trains at full width (``MESH_TRAIN``:
the exchange at (1, 2) with one chunk, the psum path at (1, 2), and at
(2, 2) the exchange with two chunks and the list and string groups split
by columns), ``dlrm_optimizer(tower_lr=1e-5)``, 3 steps of 2048 rows,
against the single-device card Trainer on the same params, batches and
labels (``mesh_train_refs``): step 1's loss ``==`` (within 1e-6 under psum
and where the data axis sums two slices), step 1's gradients (each rank's
stripe at the rows the batch touches within atol 1e-5, its other 20.97 M
rows +0.0 by count; column slices within atol 1e-5; the tower and the
replicated leaves within rtol 1e-5 / atol 1e-6), the three losses within
rtol 1e-5, the params after the steps within atol 1e-5 (the stripe at
the touched rows, 64 other rows unchanged); each step's launches asserted
(K1 1, X1 2 or 1, K3a 1, X1b 3 under the exchange or 1 under psum, one
partition launch Part in the forward for all of them) and
timed (forward, backward, the gradients' all_reduce over "data",
optimizer), with each collective's p50 and each rank's peak memory.  X1b
in its three mesh roles (the psum path's partial sums on the stripe, the
exchange's pool into its receive buffer, the owner's scatter into the
stripe) is held to its plain version at those shapes and on edge inputs
and timed, and its partition (Part) to its plain version there.  The world of 2 also runs a ``tools.scaling`` sweep (model
axes 1 and 2, both comms), the world of 4 ``entry.dryrun_multichip(4)``
and ``tools.train_multi`` for 4 steps on (2, 2).

Then it trains, through ``Trainer(...,
optimizer=dlrm_optimizer())`` on the card:

* model E with the default config (forward K1, X1, X2 and the step's one
  Part; backward K3a, and X1b once for all three gather groups), a step at
  batch 512 and five at 2048; under ``host_bucketize=False`` (K1 writes
  the searched ids K3a reads): loss and gradients ``==`` the default
  config's, the captured steps ``==`` eager at 512 and 2048;
* model E's 880 bucketize columns and tower alone
  (``make_dlrm_model(880, 0, 0, 0, 0, 32, [32], [1024, 1024, 128])``) with
  ``host_bucketize=False`` (forward K2, backward K3b), three steps.

On one card each training step runs through one captured CUDA graph per
shape signature (``Trainer._programs``): forward, loss, backward and the
optimizer's update, its first step an eager pass plus the capture.
``train_program_gate`` holds the captured step to an eager twin (the same
params, ``_capture = None``) as bits after 3 steps (every loss, param and
optimizer state leaf) at each of model E's 7 batch buckets, on the Criteo
DLRM at 512 and 2048 and on bucketize-880 at 2048, each program's kernel
nodes read back and equal to its recorded launches (K3a / K3b / X1b /
Part among them); ``step_times`` times the two in turns (host p50, the eager
step's forward / backward / optimizer split, the captured graph's device
time), and the gate reads the first step of each signature and the
reserved memory of each trainer.

Last, the Criteo DLRM (``make_criteo_dlrm()``: 26 columns at d = 64, 1.90
GB of tables, a ``dlrm_dot`` tower) at full width, on batches shaped as
``read_criteo_tsv`` gives them (``criteo_batch``: each cat id a uniform
32-bit token, spread by HashBucket over its whole vocab; the ints
log(1 + x)): served at batch 512 and 2048 (K1 once for its five one-hot
groups, X1 once), its
four kernels held against their plain versions and timed at batch 2048,
and trained (backward K3a once for its five one-hot groups, X1b once,
after the forward's one Part), a step at 512 and four at 2048.

Then the measurement tools and entry points (``tools_phases``), each
tool's JSON printed: ``tools/ae_sweep`` on model E at batch 32, 512 and
2048 (the naive per-column arm at 512: its device step and its end to
end request) and its workers sweep {2, 4} at 2048; ``tools/bw_breakdown``
(model E at 2048: the full model, embeddings only, each of its four
groups alone); ``tools/embedding_bw`` (model E's 2^23-row group; the
pooled round ``==`` X1's plain version); ``tools/ragged_bench`` (X1 at L
= 16, 32, 64, 128, ``==`` its plain version at each); ``entry()``
(``==`` ``Engine.predict``) and ``dryrun_multichip(1)``; model F at full
width (1200 columns, three 2^23 x 32 tables, 3.04 GiB; tower [2048,
1024, 1024, 512, 1] over 9704 inputs) served at 512 and 2048 (K1 1, X1 1,
X2 3 a predict; 1200 pooled columns ``==`` the oracle; rows at 100, 512
and 1500 ``==`` at 2048; K1 and X1 at its shapes); ``ae_sweep`` on model
F at 32, 512 and 2048; and ``tools/benchmark`` on model F at 2048 with
two workers under ``torch.profiler`` (the trace written, the top device
ops named).

Right after the PostPool models come random models (``fuzz_phases``,
ROADMAP item 17): ``FUZZ_SEEDS`` = 48 seeds, each a model drawn by the
port's copy of tests/test_fuzz.py's generator (``random_model``,
``random_batch``) at the card's widths (3-9 columns of every kind, dims
1-64, vocabs up to 70 000 past the one-hot limit, lists up to 128, batches
1-2048 at the tile edges) under a random single-device config
(``random_config``: every table dtype, ``use_pallas``, ``wire_pack``,
``host_bucketize``, ``dedup_subcolumns``, ``device_hash``): its pooled
outputs ``==`` the oracle, its output within rtol 1e-4 / atol 1e-5 of the
same Engine on the CPU, each kernel's launches exactly what the lowering
implies (``fuzz_launches``), and on the even f32 seeds one training step
against CPU copies (``grads_close``); then 3 mesh seeds served on a world
of 2 ranks at (1, 2), every group striped, under psum and the exchange.
Every kernel of ``KERNEL_META`` must launch in the sweep.  Last, the three
examples of ``recom_tpu_torch/examples/`` (``examples_phase``): dlrm at
model E's full width (predict at 2048, 2 training steps), microbenchmark
at 1000 columns and 2048 rows, serving at its defaults, each printing its
check against the oracle.

It checks:

1. each forward kernel (K1 one-id lookup, K2 fused bucketize + lookup, X1
   gather + pooling, one launch for all of model E's gather groups, X2
   string hashing) against its plain PyTorch version on the card, at the
   shapes its path gives it at batch 2048 (K2 also on planes holding NaN,
   +-inf, -0.0 and exact boundary values, and on ragged tiles with d in
   {1, 3, 8, 32}, V_pad 128 / 256 / 384 and edge boundary sets; K1 also on
   ragged tiles, d in {1, 3, 8, 32, 64}, V_pad 128 and 2304, missing and
   out-of-range ids and -0.0 / NaN rows, and over several groups in one
   launch, f32 and bf16: Criteo's shapes, narrow and wide groups mixed,
   searched groups with and without an id LUT on NaN, +-inf, +-0.0,
   subnormal and boundary values, their ids ``==`` too; X1 also on d in {1, 3, 8, 32, 64}
   x L in {1, 2, 12, 33}, all-missing and zero-weight bags, -0.0 / NaN /
   +-inf rows; X2 also on
   512-byte rows with more than L = 128 pieces, delimiters first, last,
   everywhere and >= 0x80, odd itemsizes, every FarmHash length and bucket
   counts 1 .. 2^31): exact equality (``==``, so +0 == -0, with NaN where
   the plain version has it for X1; as bits for K1 and K2);
2. each backward kernel (K3a of K1, one launch for every one-hot group;
   K3b of K2; X1b of X1, one launch for all of model E's gather groups)
   and the partition Part that lists their work items' entries (its
   slots, values and offsets ``==`` its plain version as integers, at each
   path's and mesh role's shapes) at its path's shapes at batch 2048 (K3a
   with missing and past-cap ids added, K3b on a plane holding NaN, +-inf,
   +-0.0 and exact boundaries; X1b also into outputs filled with NaN, so
   that every element must be written) and on edge inputs (K3a: C not a
   multiple of the columns an item takes, Bp past a stage and past a pass,
   V_pad 384 and 2304, d 1 to 64, all of them in one launch, the Criteo
   DLRM's vocabularies with a column whose 2048 entries hit one row and a
   column with none; K3b: K2's 12 edge planes, and Bp past a stage; X1b:
   2048 slots on one row of a dense tile and of a sparse range; d in {1, 3, 8, 32, 64} x L in {1, 2, 12, 33}, weighted MEAN
   / SQRTN, all-missing and zero-weight bags, ids at and past caps, and
   groups that mix small-vocab members (dense tiles) with large-vocab ones
   (sparse ranges), one with all its slots in one range, one hot row, one
   range crowded past a window, at d 3, 8, 32 and 64): two runs give the
   same bits, equal to the plain version on CPU copies (``index_add_`` in
   slot order), and within 1e-5
   of the terms' magnitudes of the plain version on the card (whose
   ``index_add_`` adds with atomics);
3. for every kernel, its time (warm, and with L2 flushed before each call),
   the plain version's and, where one exists, one PyTorch call computing
   the same function (``library_ms``, a yardstick the port never calls;
   for the backward kernels ``torch.zeros`` + ``index_add_`` of
   precomputed contributions), and the least time the card could take (X2:
   bytes, or integer operations counted from this batch's pieces over the
   INT32 rate, whichever is larger); X1b also per class of member (model
   E: the small-vocab groups alone, the large-vocab group alone; Criteo:
   its one gather group with no ids, with only its members of dense
   tiles, with only those of sparse ranges);
   The stored-dtype variants K1-bf16, K2-bf16, X1-bf16 and X1-int8 at
   their paths' shapes and on edge inputs: ragged tiles, bf16 rows of
   -0.0, NaN, +-inf, subnormals and rounding ties, int8 rows at -127,
   zero rows (scale 0) and scales over 12 orders of magnitude, d in {1,
   3, 8, 12, 32, 64}, L in {1, 2, 33, 128}, weighted and unweighted
   columns under every combiner (K1-bf16 and K2-bf16 as bits, X1's with
   ==); X1, X1-bf16 and X1-int8 also on unweighted one-id groups (C = 45,
   Bp = 100, ids past caps and below 0) mixed with bag groups in each
   launch, the one-id tile's cases; the one-id group timed alone
   (``x1_oneid_alone``; under int8 also its members of <= 128 rows and
   the larger ones, each alone) and X1's f32 launch with its one-id
   groups on each tile, in turns (``x1_oneid_f32_ab``: models E and F,
   the Criteo DLRM);
4. that each ``predict``, pipelined request and training step (also on
   the mesh layouts, per rank) went through its path's kernels and no other (model E: one launch of X1 a predict; a training
   step K1 1, X1 1, X2 3, K3a 1, X1b 1 and Part 1, under
   ``host_bucketize=False`` too; the bucketize path K2 1 and K3b 1 a step
   (its one vocab tile needs no Part); Criteo: K1 1 and X1 1 a predict,
   and K3a 1, X1b 1 and Part 1 more a step; each PostPool model: K1 once, X1 once, X2 a group of
   strings hashed on the card, and K3a and X1b to match a step): the
   launch counts are zeroed just before and read just after;
5. pooled outputs of every column against the port's NumPy oracle
   exactly (for bf16 and int8 tables, the oracle on the engine's own
   export: the stored values as f32), and the model output at rtol 1e-4
   / atol 1e-5 (model E,
   Criteo), at rtol 1e-5 / atol 1e-6 with the concat at rtol 1e-6 / atol
   1e-6 (the PostPool models) or exactly (the microbenchmark's identity
   tower); the first training step's loss against the masked BCE of the
   oracle's logits at rtol 1e-4, finite losses falling on a fixed batch,
   ``predict`` serving the updated params, and the PostPool models'
   training step against the same step on the CPU (pooled outputs'
   cotangents and tower gradients within 1e-5, table gradients equal to
   the bit to the CPU's backward of the card's cotangents);
6. median ``predict`` latency of each path, ``Engine.benchmark``'s step
   time on the microbenchmark, and the median training step time, eager
   and captured in turns, with the eager step's forward / backward /
   optimizer split and the captured graph's device time (CUDA events) and
   peak memory.

The last lines of stdout are one JSON object for the kernels (each also
under ``criteo`` where the Criteo DLRM's path runs it, and with its
``runtime_launches`` in the serving-runtime phases), the card's name
and power limit as nvidia-smi reports them, and ``{"ok": true,
"device": {...}}``.  Any failed check raises: the script then exits non-zero
and prints no result.  Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import gc
import json
import statistics
import struct
import subprocess
import sys
import threading
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and f32 FLOP/s
# outside the tensor cores.  The INT32 rate is 132 SMs x 64 lanes x the SM
# clock nvidia-smi reports as clocks.max.sm (int32_ops_per_s).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
H100_SMS, INT32_LANES_PER_SM = 132, 64
# about 0.1 s of an H100's ~2 GHz clock: long enough for the host to queue
# every timed call behind it
SLEEP_CYCLES = 200_000_000
# written between calls to flush the H100's 50 MB L2 (time_cold_ms)
FLUSH_BYTES = 128 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def int32_ops_per_s() -> float:
    """132 SMs x 64 INT32 lanes x the card's top SM clock."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return H100_SMS * INT32_LANES_PER_SM * mhz * 1e6


# Integer operations of one FarmHash Fingerprint64 by length branch (0,
# 1-3, 4-7, 8-16, 17-32, 33-64 bytes), counted from csrc/hash_device.cu: a
# 64-bit multiply is four 32-bit multiply-adds; a 64-bit add, xor, shift or
# rotate is two operations; a 32-bit one is one; byte fetches are loads.
HASH_OPS = (0, 22, 32, 46, 58, 116)
# the modulo: umulhi(h, M) (a 64-bit multiply), a 32-bit multiply, a
# subtract, a compare and the one correction
MOD_OPS = 8


def x2_int_ops(torch, raw, widths, delims, bp: int, wbk: int,
               rowlen: int) -> int:
    """Integer operations kernel X2 needs for this batch: one test per
    staged byte (finding row lengths and delimiters), plus each piece's
    hash by its length branch and its modulo."""
    from recom_tpu_torch.ops.hash_device import (
        row_lengths,
        split_pieces,
        verbatim_rows,
    )

    rows = verbatim_rows(raw, widths, bp, wbk)
    if delims is None:
        plen = row_lengths(rows).reshape(-1)
    else:
        _, lens, npieces = split_pieces(rows, delims, rowlen)
        valid = (torch.arange(rowlen, device=raw.device)
                 < npieces[..., None])
        plen = lens[valid]
    edges = torch.tensor([1, 4, 8, 17, 33], device=raw.device)
    branch = torch.bucketize(plen, edges, right=True)
    ops = torch.tensor(HASH_OPS, device=raw.device)[branch] + MOD_OPS
    return int(widths.long().sum()) * bp + int(ops.sum())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3,
            queued: bool = True) -> float:
    """Mean time of ``fn`` over back-to-back calls, from CUDA events.

    ``queued``: a sleep kernel first holds the card while the host enqueues
    every call, so the events see the device work alone; a wrapper's Python
    dispatch can outlast a 10 us kernel.  Unqueued, the host paces the
    calls, as it does for a real caller."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def time_cold_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` with L2 flushed before each call, as a serving
    caller finds it after the rest of ``predict``: a FLUSH_BYTES buffer is
    written between calls, outside the timed window (a pair of CUDA events
    around each call), all queued behind a sleep kernel."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for i, (t0, t1) in enumerate(events):
        buf.fill_(float(i))
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in events) / iters


def require_launches(counts, kids, path: str, exactly=None) -> None:
    """The path launched each of its kernels ``kids`` (``exactly`` those
    counts where given) and no other kernel."""
    for kid, n in counts.items():
        if kid in kids:
            require(n > 0, f"{path}: predict did not launch kernel {kid}")
        else:
            require(n == 0, f"{path}: predict launched kernel {kid} {n} x, "
                    "which is not on its path")
    for kid, n in (exactly or {}).items():
        require(counts.get(kid, 0) == n, f"{path}: kernel {kid} launched "
                f"{counts.get(kid, 0)} x, expected {n}")


def check_micro(ref, out, bs: int) -> None:
    """The microbenchmark's 1000 pooled columns and its output (the
    identity tower: the concatenation) == the oracle."""
    import numpy as np

    require(len(ref["pooled"]) == 1000, "1000 pooled columns")
    bad = [c for c, r in ref["pooled"].items()
           if not np.array_equal(out["pooled"][c], r)]
    require(not bad, f"micro pooled outputs differ from the oracle: "
            f"{bad[:5]}")
    require(out["output"].shape == (bs, 8000)
            and np.array_equal(out["output"], ref["output"]),
            "micro output != oracle output")
    log(f"micro-1000 batch {bs}: pooled outputs of all 1000 columns and the "
        "output == oracle")


def latency(torch, eng, name: str, cases) -> None:
    """Median ``predict`` latency (host clock, 10 calls), its stages, and
    the device forward alone (CUDA events), for each (batch size, batch)."""
    from recom_tpu_torch.utils import spans

    for bs, batch in cases:
        for _ in range(2):
            eng.predict(batch)
        spans.enable()
        lat = []
        for _ in range(10):
            t = time.perf_counter()
            eng.predict(batch)
            lat.append((time.perf_counter() - t) * 1e3)
        log(f"{name}: predict latency batch {bs}: median "
            f"{statistics.median(lat):.3f} ms (min {min(lat):.3f}, max "
            f"{max(lat):.3f}, 10 calls; host prep + H2D + device + D2H)")
        stages = spans.summary()
        spans.disable()
        log(f"  stage p50 ms (host clock): " + ", ".join(
            f"{k} {v['p50_ms']}" for k, v in sorted(stages.items())))
        prep = eng.prepare(batch)
        on_dev = eng.to_device(prep)
        fwd = lambda: eng._forward(on_dev, prep.signature)
        with torch.inference_mode():
            fwd_dev = time_ms(torch, fwd, iters=10)
            fwd_paced = time_ms(torch, fwd, iters=10, queued=False)
        log(f"  device forward (unpack + lookups + tower, CUDA events): "
            f"{fwd_dev:.4f} ms queued, {fwd_paced:.4f} ms host-paced")


def bound_ms(nbytes: float, flops: float = 0.0, int_ops: float = 0.0,
             int_rate: float = 1.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOPS_PER_S, int_ops / int_rate) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# TF DataType enum values and the TF ops of each feature-column idiom the
# GraphDef writer emits
DT_FLOAT, DT_STRING, DT_INT64 = 1, 7, 9
TF_POOL = {"MEAN": "SparseSegmentMean", "SUM": "SparseSegmentSum"}


def model_graphdef(model) -> bytes:
    """A frozen TF feature-column GraphDef of a ``make_dlrm_model`` model
    (model E at full width), as ``tf.feature_column.input_layer`` emits its
    columns, written with the port's protobuf wire writer
    (``importers/protowire``):

    * bucketized: ``Placeholder`` (f32) -> ``Bucketize``;
    * int hash: ``Placeholder`` (int64) -> ``AsString`` ->
      ``StringToHashBucketFast``;
    * string hash: ``Placeholder`` (string) -> ``StringToHashBucketFast``;
    * delimited lists: ``StringSplit`` on a ``Const`` delimiter ->
      ``StringToHashBucketFast`` of its values;
    * each table a ``VariableV2`` with its ``shape`` attr (the weights are
      not in the graph: a few MB of graph for model E's 5.37 GB of
      tables), pooled by ``SparseSegmentMean`` or ``SparseSegmentSum``;
    * dense inputs as ``Placeholder``s; one ``ConcatV2`` of every slot in
      model order.

    Node names are the model's fields and tables, so the import gives back
    its columns and tables."""
    from recom_tpu_torch.importers.protowire import field_bytes, field_varint
    from recom_tpu_torch.ir.spec import Bucketize, FeatureKind, HashBucket

    def shape(dims):
        return field_bytes(7, b"".join(
            field_bytes(2, field_varint(1, d)) for d in dims))

    def attr(key, value):
        return field_bytes(5, field_bytes(1, key.encode())
                           + field_bytes(2, value))

    def node(name, op, inputs=(), **attrs):
        body = field_bytes(1, name.encode()) + field_bytes(2, op.encode())
        body += b"".join(field_bytes(3, i.encode()) for i in inputs)
        body += b"".join(attr(k, v) for k, v in attrs.items())
        return field_bytes(1, body)

    def dtype(t):
        return field_varint(6, t)

    parts, slots = [], []
    for col in model.columns:
        f = col.source.field
        if col.lookup is None:
            parts.append(node(f, "Placeholder", dtype=dtype(DT_FLOAT)))
            slots.append(f)
            continue
        kind, (tf_,) = col.source.kind, col.transforms
        if kind == FeatureKind.DENSE_FLOAT and isinstance(tf_, Bucketize):
            floats = b"".join(struct.pack("<f", b) for b in tf_.boundaries)
            parts += [
                node(f, "Placeholder", dtype=dtype(DT_FLOAT)),
                node(f"{f}/Bucketize", "Bucketize", [f], boundaries=(
                    field_bytes(1, field_bytes(4, floats)))),
            ]
            ids = f"{f}/Bucketize"
        else:
            require(isinstance(tf_, HashBucket), f"{f}: no writer for "
                    f"{type(tf_).__name__}")
            src = f
            if kind == FeatureKind.DENSE_INT:
                parts += [node(f, "Placeholder", dtype=dtype(DT_INT64)),
                          node(f"{f}/AsString", "AsString", [f])]
                src = f"{f}/AsString"
            elif kind == FeatureKind.STRING:
                parts.append(node(f, "Placeholder", dtype=dtype(DT_STRING)))
            else:
                require(kind == FeatureKind.STRING_LIST, f"{f}: {kind}")
                delim = field_bytes(8, field_varint(1, DT_STRING)
                                    + field_bytes(2, b"")
                                    + field_bytes(8, col.source.delimiter
                                                  .encode()))
                parts += [
                    node(f, "Placeholder", dtype=dtype(DT_STRING)),
                    node(f"{f}/delimiter", "Const", value=delim),
                    node(f"{f}/StringSplit", "StringSplit",
                         [f, f"{f}/delimiter"]),
                ]
                src = f"{f}/StringSplit:1"
            parts.append(node(f"{f}/Hash", "StringToHashBucketFast", [src],
                              num_buckets=field_varint(3, tf_.num_buckets)))
            ids = f"{f}/Hash"
        t = model.tables[col.lookup.table]
        pool = f"{f}/{TF_POOL[col.lookup.combiner.name]}"
        parts += [
            node(t.name, "VariableV2", dtype=dtype(DT_FLOAT),
                 shape=shape((t.vocab_size, t.dim))),
            node(pool, TF_POOL[col.lookup.combiner.name],
                 [t.name, ids, f"{f}/segment_ids"]),
        ]
        slots.append(pool)
    parts += [
        node("input_layer/concat/axis", "Const"),
        node("input_layer/concat", "ConcatV2",
             slots + ["input_layer/concat/axis"],
             N=field_varint(3, len(slots))),
    ]
    return b"".join(parts)


EDGE_BUCKETS = (1, 7, (1 << 31) - 5, (1 << 31) - 1, 1 << 31)


def _s_buffer(rows, bp: int, wbk: int):
    """Rows as numpy 'S' buffers staged verbatim, as runtime/wire.py does:
    [n, bp * wbk] bytes and [n] itemsizes."""
    import numpy as np

    raw = np.zeros((len(rows), bp * wbk), np.uint8)
    widths = np.zeros(len(rows), np.int32)
    for i, col in enumerate(rows):
        arr = np.asarray(col, dtype="S")
        widths[i] = arr.dtype.itemsize
        buf = arr.view(np.uint8).ravel()
        raw[i, : buf.size] = buf
    return raw, widths


def x2_edge_cases(seed: int = 0):
    """Inputs on which X2's staging, split and piece lists have edges, one
    dict per case: name, cols (the rows of each column, bytes), raw and
    widths (as the wire stages them), delim (a byte, or None for fixed
    columns), bp, wbk (the width bucket) and rowlen.  Five columns each,
    for the bucket counts EDGE_BUCKETS."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = [0, 1, 3, 4, 7, 8, 15, 16, 17, 31, 32, 33, 63, 64]

    def piece(n, avoid):
        return bytes(rng.integers(1, 256, n).astype(np.uint8)).replace(
            avoid, b"\x01")

    def split_cols(bp, delim, max_pieces, max_piece):
        """The delimiter first, last, and as every byte; an empty row;
        up to max_pieces pieces of every length up to max_piece."""
        d = bytes([delim])
        lens = [x for x in lengths if x <= max_piece]
        cols = []
        for i in range(len(EDGE_BUCKETS)):
            rows = [d.join(piece(int(n), d) for n in rng.choice(
                lens, int(rng.integers(1, max_pieces + 1))))
                for _ in range(bp)]
            rows[:6] = [b"", d + rows[1], rows[2] + d, d * (5 + 7 * i), d,
                        piece(64, d)]
            cols.append(rows)
        return cols

    cases = [
        ("512-byte rows, L = 128, up to 129 pieces", 77,
         split_cols(77, ord(";"), 129, 3), ord(";"), 128, 512),
        ("0xFE delimiter, every piece length, rows over 300 bytes", 300,
         split_cols(300, 0xFE, 9, 64), 0xFE, 12, None),
    ]
    fixed = []
    for width in (1, 13, 30, 61, 64):
        lens = [min(n, width) for n in lengths]
        rows = [piece(int(rng.choice(lens)), b"\x00") for _ in range(1000)]
        rows[0] = piece(width, b"\x00")             # fixes the itemsize
        fixed.append(rows)
    cases.append(("fixed, itemsizes 1/13/30/61/64, 1000 rows", 1000, fixed,
                  None, 1, None))
    out = []
    for name, bp, cols, delim, rowlen, wbk in cases:
        width = max(np.asarray(c, dtype="S").dtype.itemsize for c in cols)
        wbk = wbk or ((width + 4 + 3) // 4) * 4
        raw, widths = _s_buffer(cols, bp, wbk)
        out.append(dict(name=name, cols=cols, raw=raw, widths=widths,
                        delim=delim, bp=bp, wbk=wbk, rowlen=rowlen))
    return out


def k1_edge_case(c: int, v: int, d: int, b: int, seed: int,
                 specials: bool = True):
    """K1 inputs on tiles that do not divide C and Bp: a zero-padded
    [C_pad, V_pad, d] table3 (with ``specials``, -0.0 and NaN rows), ids
    with an all-missing column, ids past their caps and below -1, and
    caps."""
    import numpy as np

    rng = np.random.default_rng(seed)
    c_pad, v_pad = ((c + 7) // 8) * 8, ((v + 127) // 128) * 128
    t3 = np.zeros((c_pad, v_pad, d), np.float32)
    t3[:c, :v] = rng.standard_normal((c, v, d)).astype(np.float32)
    if specials:
        bits = t3.view(np.int32)
        bits[:, 0::3] = np.int32(-2**31)
        bits[:, 1::5] = np.int32(0x7FC0_1234)
    ids = rng.integers(-5, v + 40, (c, b)).astype(np.int32)
    ids[c // 2] = -1
    ids[0, :3] = [-2, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    caps = rng.integers(v // 2, v, c).astype(np.int32)
    return t3, ids, caps


# K1's edge shapes (C, V, Bp, d): tiles that do not divide C and Bp, d off
# (1, 3) and on (8, 32, 64) the float4 path, model E's 930 columns, and
# the Criteo DLRM's d = 64 at its largest one-hot vocab (2209, V_pad 2304)
K1_EDGES = ((45, 101, 100, 1), (45, 101, 100, 3), (45, 101, 100, 8),
            (45, 101, 100, 32), (45, 101, 100, 64), (930, 101, 2000, 8),
            (9, 2209, 700, 64))

# K3a's edge shapes (C, V, Bp, d): C not a multiple of the columns an item
# takes; Bp past a stage of its ring (700; at d = 64 a stage is 120 batch
# rows) and past a pass (2000, 5000; at d = 64 a pass is 960 rows); V_pad
# 384 and the Criteo DLRM's 2304 at d = 64, 36 items a column
K3A_EDGES = ((45, 300, 100, 1), (45, 300, 100, 3), (45, 300, 100, 32),
             (45, 300, 700, 8), (930, 300, 2000, 8), (9, 300, 5000, 8),
             (45, 300, 700, 64), (9, 2209, 2048, 64))

# X1's edge shapes: row lengths off (1, 3) and on (8, 32, 64) the float4
# path (64: the Criteo DLRM's, 16 lanes a bag), and bag lengths 1 (its own
# path), 2, 12 (model E's lists) and 33 (past four chunks of 8)
X1_EDGE_D = (1, 3, 8, 32, 64)
X1_EDGE_L = (1, 2, 12, 33)


def k1_searched_case(rng, nbz: int, nhost: int, v: int, d: int, b: int,
                     lut: bool):
    """A one-hot group whose first nbz columns K1 searches: (table3, host
    ids, caps, ``Searched`` fields as numpy: raw, hi, counts, lut).  Every
    member has more buckets than rows under a LUT (it maps them), at most
    V - 1 boundaries without; the raw values hold NaN, +-inf, +-0.0,
    subnormals, exact boundaries (a repeated one among them) and the
    floats just below them."""
    import numpy as np

    from recom_tpu_torch.ops.lookup_onehot import searched_bounds

    c = nbz + nhost
    t3 = rng.standard_normal((c + 1, v, d)).astype(np.float32)
    t3[-1] = 0.0
    kmax = 2 * v if lut else v - 1
    bm = np.full((nbz, kmax), np.inf, np.float32)
    cnt = rng.integers(0, kmax + 1, nbz).astype(np.int32)
    cnt[0] = kmax
    for i in range(nbz):
        bm[i, :cnt[i]] = np.sort(rng.standard_normal(cnt[i])
                                 .astype(np.float32))
    if cnt[0] > 3:
        bm[0, 2] = bm[0, 1]
    raw = rng.standard_normal((nbz, b)).astype(np.float32)
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40,
                         1.4e-45], np.float32)
    raw[:, :len(specials)] = specials
    n = (b - len(specials)) // 2
    for i in range(nbz):
        if cnt[i]:
            hits = bm[i, (np.arange(n) * 7) % cnt[i]]
            raw[i, len(specials): len(specials) + n] = hits
            raw[i, len(specials) + n: len(specials) + 2 * n] = np.nextafter(
                hits, np.float32(-np.inf))
    lm = rng.integers(-1, v, (nbz, kmax + 1)).astype(np.int32) if lut \
        else None
    hi, counts, lm = searched_bounds(bm, cnt, lm)
    host = rng.integers(-2, v + 3, (nhost, b)).astype(np.int32)
    caps = rng.integers(v // 2, v, c).astype(np.int32)
    return t3, host, caps, (raw, hi, counts, lm)


# K1's launches of several groups: (name, [(C, nbz, V, d, lut)], Bp): the
# Criteo DLRM's five one-column groups at d = 64; narrow and wide groups
# mixed, off and on the float4 path; searched groups (model E's 880 + 50
# shape, with and without a LUT) among plain ones
K1_GROUP_CASES = (
    ("criteo", [(1, 0, v, 64, False) for v in (3, 155, 976, 2209, 5000)],
     2048),
    ("narrow and wide", [(1, 0, 10, 64, False), (45, 0, 101, 8, False),
                         (3, 0, 7, 3, False), (64, 0, 384, 12, False),
                         (2, 0, 40, 1, False)], 513),
    ("searched", [(930, 880, 128, 8, True), (930, 880, 101, 8, False),
                  (5, 5, 50, 8, True), (7, 3, 40, 3, True),
                  (1, 0, 155, 64, False)], 2048),
)


def k1_group_cases(torch) -> None:
    """K1 over several groups in one launch (``K1_GROUP_CASES``), f32 and
    bf16 tables: the outputs and, under autograd, the searched groups'
    [C, Bp] ids ``==`` the wrapper on CPU copies (the plain version) as
    bits; one launch a case."""
    import numpy as np

    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.ops.lookup_onehot import Searched, _onehot_lookups

    rng = np.random.default_rng(18)
    for name, shapes, bp in K1_GROUP_CASES:
        groups = []
        for c, nbz, v, d, lut in shapes:
            if nbz:
                t3, host, caps, srch = k1_searched_case(rng, nbz, c - nbz, v,
                                                        d, bp, lut)
                groups.append((t3, host, caps, srch))
            else:
                t3 = rng.standard_normal((c + 1, v, d)).astype(np.float32)
                t3[-1] = 0.0
                t3[0, 0, 0] = np.float32(-0.0)
                ids = rng.integers(-2, v + 3, (c, bp)).astype(np.int32)
                caps = rng.integers(v // 2, v, c).astype(np.int32)
                groups.append((t3, ids, caps))
        for dtype in (torch.float32, torch.bfloat16):
            def on(dev):
                out = []
                for g in groups:
                    t = torch.from_numpy(g[0]).to(dev, dtype)
                    rest = [torch.from_numpy(x).to(dev) for x in g[1:3]]
                    if len(g) == 4:
                        rest.append(Searched(*(
                            None if x is None else torch.from_numpy(x).to(dev)
                            for x in g[3])))
                    out.append((t, *rest))
                return out

            card = on("cuda")
            before = dict(kernels.launches)
            got, ids = _onehot_lookups(card, want_ids=True)
            torch.cuda.synchronize()
            kid = "K1" if dtype == torch.float32 else "K1-bf16"
            require(kernels.launches[kid] - before[kid] == 1,
                    f"K1 group case {name}: one launch")
            want, want_ids = _onehot_lookups(on("cpu"), want_ids=True)
            for k, (a, b) in enumerate(zip(got, want)):
                require(a.shape == b.shape and torch.equal(
                    a.cpu().view(torch.int32), b.view(torch.int32)),
                    f"K1 group case {name} ({dtype}), group {k}: kernel != "
                    "plain as bits")
            for k, (a, b) in enumerate(zip(ids, want_ids)):
                require(torch.equal(a.cpu(), b), f"K1 group case {name}, "
                        f"group {k}: ids != plain")
            served = _onehot_lookups(card)[0]
            torch.cuda.synchronize()
            require(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(served, got)),
                    f"K1 group case {name}: serving (no ids) != autograd's")
        log(f"K1 group case {name} (Bp {bp}; (C, searched, V, d, LUT) "
            f"{shapes}): f32 and bf16, one launch each, == plain as bits, "
            "searched ids == plain")


def x1_edge_case(d: int, l: int, seed: int, specials: bool = True):
    """X1 inputs on a ragged tile (C = 6 members, Bp = 100): a stacked
    [R, d] table (with ``specials``, -0.0 rows and NaN / +-inf rows, never
    in a member's row 0, which a missing slot reads in the reference, and
    no +-inf row in a bag's first slot), ids
    [C, Bp, L] with all-missing bags and ids past their caps and below -1,
    row offsets, caps, combiner codes (sum, mean, sqrtn), weights [C, Bp,
    L] with zero-weight MEAN and SQRTN bags, and the per-column rounding
    (divide or reciprocal)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    c, bp = 6, 100
    vocab = rng.integers(5, 40, c)
    offs = np.concatenate([[0], np.cumsum(vocab)[:-1]]).astype(np.int32)
    table = rng.standard_normal((int(vocab.sum()), d)).astype(np.float32)
    if specials:
        inner = np.setdiff1d(np.arange(table.shape[0]), offs)
        pick = rng.permutation(inner)
        table[pick[0::7]] = -0.0
        table[pick[1::11]] = np.nan
        table[pick[2::13]] = np.inf
        table[pick[3::17]] = -np.inf
    ids = rng.integers(-3, vocab[:, None, None] + 6, (c, bp, l)).astype(np.int32)
    ids[:, 7] = -1                                  # all-missing bags
    ids[0, 0, :3] = [-2, np.iinfo(np.int32).min, np.iinfo(np.int32).max][:l]
    caps = (vocab - 1 - rng.integers(0, 3, c)).astype(np.int32)
    if specials and l > 1:
        # the reference starts a ragged sum at (first slot's row) x 0, so
        # an inf row there makes it NaN where the oracle's sum is inf:
        # such bags point their first slot at the member's row 0
        first = np.minimum(ids[:, :, 0], caps[:, None])
        row = offs[:, None] + np.maximum(first, 0)
        ids[:, :, 0][(first >= 0) & np.isinf(table[row]).any(-1)] = 0
    codes = np.asarray([0, 1, 2, 1, 2, 0], np.int32)
    weights = rng.uniform(0.1, 2.0, (c, bp, l)).astype(np.float32)
    weights[:, 9] = 0.0                             # zero-weight bags
    wcols = np.asarray([True, False, True, False, True, False])
    return table, ids, offs, caps, codes, weights, wcols


def x1_oneid_case(d: int, seed: int, specials: bool = True):
    """X1 inputs for the one-id tile, on two ragged tiles each way (C = 45
    members, Bp = 100): a stacked [R, d] table (with ``specials``, -0.0,
    NaN and +-inf rows, never a member's row 0, which a missing id reads in
    the reference), ids [C, Bp, 1] with missing ids (-1, -2, int32 min), ids
    past their caps and at int32 max, row offsets, caps, combiner codes
    (sum, mean, sqrtn) and the per-column rounding (divide or reciprocal),
    with no weights plane."""
    import numpy as np

    rng = np.random.default_rng(seed)
    c, bp = 45, 100
    vocab = rng.integers(5, 40, c)
    offs = np.concatenate([[0], np.cumsum(vocab)[:-1]]).astype(np.int32)
    table = rng.standard_normal((int(vocab.sum()), d)).astype(np.float32)
    if specials:
        pick = rng.permutation(np.setdiff1d(np.arange(table.shape[0]),
                                            offs))
        table[pick[0::5]] = -0.0
        table[pick[1::7]] = np.nan
        table[pick[2::11]] = np.inf
        table[pick[3::13]] = -np.inf
    ids = rng.integers(-3, vocab[:, None, None] + 6, (c, bp, 1)).astype(
        np.int32)
    ids[:, 7] = -1
    ids[:3, 0, 0] = [-2, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    caps = (vocab - 1 - rng.integers(0, 3, c)).astype(np.int32)
    codes = (np.arange(c) % 3).astype(np.int32)
    wcols = np.arange(c) % 2 == 1
    return table, ids, offs, caps, codes, None, wcols


# X1b's class cases (d, weighted, crowded); at d = 64 (the Criteo DLRM's) a
# dense tile and a window are 64 rows
X1B_CLASS_CASES = ((8, False, False), (32, True, False), (3, True, False),
                   (8, False, True), (64, False, False), (64, True, False),
                   (64, False, True))


def x1b_class_case(d: int, seed: int, weighted: bool, crowded: bool = False):
    """X1b inputs whose members take both of X1b's classes: (g [Bp, C, d],
    R, ids [C, Bp, L], row offsets, caps, combiner codes, weights or None,
    weighted_cols), numpy.  Members: a small vocab (dense tiles); a large
    one whose slots span every range; one whose slots all fall in one
    range; one with a hot row; rows past the last member.  ``crowded``:
    one large member whose slots touch 30 000 rows of one range, more than
    a window holds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if crowded:
        vocab, bp, ll = np.asarray([1 << 20]), 4096, 8
        ids = rng.integers(0, 30_000, (1, bp, ll))
    else:
        vocab, bp, ll = np.asarray([300, 200_000, 150_000, 90_000]), 64, 3
        ids = np.stack([rng.integers(-2, v + 3, (bp, ll)) for v in vocab])
        ids[2] = rng.integers(0, 1000, (bp, ll))      # all in one range
        ids[3, :, 0] = 5                              # a hot row
    c = len(vocab)
    offs = np.concatenate([[0], np.cumsum(vocab)[:-1]]).astype(np.int32)
    codes = np.asarray([0, 1, 2, 0][:c], np.int32)
    g = rng.standard_normal((bp, c, d)).astype(np.float32)
    w = rng.uniform(0.1, 2.0, (c, bp, ll)).astype(np.float32)
    return (g, int(vocab.sum()) + 77, ids.astype(np.int32), offs,
            (vocab - 1).astype(np.int32), codes, w if weighted else None,
            np.full(c, weighted))


def k2_edge_case(c: int, v_pad: int, d: int, b: int, seed: int):
    """K2 inputs on tiles that do not divide C and Bp: a boundary matrix
    [C, v_pad - 1] and its counts, with column 0 holding no boundary,
    column 1 v_pad - 1 of them (the most bucket_bounds takes), column 2
    one value repeated, column 3 only -inf, column 4 two f64 boundaries
    that ceil32 merges; a zero-padded table3 [C_pad, v_pad, d]; and raw
    [C, b] holding NaN, +-inf, +-0.0, the least subnormals, each column's
    boundaries and the float below each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kmax = v_pad - 1
    bmat = np.full((c, kmax), np.inf, np.float32)
    cnts = rng.integers(1, kmax + 1, c).astype(np.int32)
    for i in range(c):
        steps = rng.uniform(0.25, 3.0, cnts[i])
        bmat[i, : cnts[i]] = np.cumsum(steps) - steps.sum() / 2
    bmat[:5] = np.inf
    cnts[0] = 0
    cnts[1] = kmax
    bmat[1] = np.arange(kmax, dtype=np.float32) * 0.5 - 30.0
    cnts[2] = 9
    bmat[2, :9] = 2.5
    cnts[3] = 4
    bmat[3, :4] = -np.inf
    # ceil32 of (-1.0, 1.5 + 1e-12, 1.5 + 2e-12, 4.0): the middle two merge
    up = np.nextafter(np.float32(1.5), np.float32(np.inf))
    cnts[4] = 4
    bmat[4, :4] = [-1.0, up, up, 4.0]
    c_pad = ((c + 7) // 8) * 8
    table3 = np.zeros((c_pad, v_pad, d), np.float32)
    table3[:c] = rng.standard_normal((c, v_pad, d)).astype(np.float32)
    raw = rng.uniform(-60, 60, (c, b)).astype(np.float32)
    raw[:, :5] = [np.nan, np.inf, -np.inf, -0.0, 0.0]
    for i in range(c):
        k = max(int(cnts[i]), 1)
        hits = bmat[i, rng.integers(0, k, 16)]
        raw[i, 5:21] = hits
        raw[i, 21:37] = np.nextafter(hits, np.float32(-np.inf))
    raw[4, 37:40] = [up, 1.5, 4.0]
    tiny = np.nextafter(np.float32(0), np.float32(1))   # the least subnormal
    raw[:, 40:42] = [-tiny, tiny]
    return bmat, cnts, table3, raw


# each kernel's source and the TPU-side function it replaces (the
# stored-dtype variants: the reference's upcast or dequantize after the
# row load)
KERNEL_META = {
    "K1": ("recom_tpu_torch/csrc/onehot_lookup.cu",
           "recom_tpu/ops/lookup_pallas.py:36"),
    "K2": ("recom_tpu_torch/csrc/onehot_bucketize.cu",
           "recom_tpu/ops/lookup_pallas.py:92"),
    "X1": ("recom_tpu_torch/csrc/pooled_gather.cu",
           "recom_tpu/ops/lookup_xla.py:185"),
    "K1-bf16": ("recom_tpu_torch/csrc/onehot_lookup.cu",
                "recom_tpu/ops/lookup_pallas.py:49"),
    "K2-bf16": ("recom_tpu_torch/csrc/onehot_bucketize.cu",
                "recom_tpu/ops/lookup_pallas.py:128"),
    "X1-bf16": ("recom_tpu_torch/csrc/pooled_gather.cu",
                "recom_tpu/ops/lookup_xla.py:61"),
    "X1-int8": ("recom_tpu_torch/csrc/pooled_gather.cu",
                "recom_tpu/ops/quant.py:47"),
    "X2": ("recom_tpu_torch/csrc/hash_device.cu",
           "recom_tpu/ops/hash_device.py:234"),
    "K3a": ("recom_tpu_torch/csrc/onehot_grad.cu",
            "recom_tpu/ops/lookup_pallas.py:321"),
    "K3b": ("recom_tpu_torch/csrc/onehot_grad.cu",
            "recom_tpu/ops/lookup_pallas.py:211"),
    "X1b": ("recom_tpu_torch/csrc/pooled_gather_grad.cu",
            "recom_tpu/ops/lookup_xla.py:61"),
    # the partition pass of K3a, K3b and X1b: a phase of their ports (the
    # scatter-adds of K3a's _bwd, K3b's and XLA's autodiff of X1's)
    "Part": ("recom_tpu_torch/csrc/partition.cu",
             "recom_tpu/ops/lookup_pallas.py:321"),
}


def k1_call(torch, eng, pairs, bp: int):
    """K1's record for the one-hot groups ``pairs`` ([(group, its [C, Bp,
    1] ids)]) of ``eng``, one launch for all of them (K1-bf16's for bf16
    tables): the kernel, its plain version, the library yardstick
    (``F.embedding`` over each flattened table3, missing ids pointed at a
    zero padding plane; then ``.float()`` for bf16, the same function,
    since the rows are copies) and the bound (ids, caps, the distinct rows
    selected at their stored width and the f32 output, each once)."""
    import torch.nn.functional as F

    from recom_tpu_torch.ops.lookup_onehot import (
        onehot_lookup_plain,
        onehot_lookups,
    )

    args, libs, nbytes, shapes = [], [], 0, []
    for g, ids in pairs:
        dev = ids.device
        c = eng._consts[g.gid]
        table = eng.device_params["stacked"][str(g.gid)]
        ids2 = ids[:, :, 0].contiguous()
        caps = c["caps"]
        cc, v, d = g.num_columns, table.shape[1], table.shape[2]
        zero_row = (table.shape[0] - 1) * v
        require(table.shape[0] > cc and bool((table[-1] == 0).all()),
                "zero padding plane")
        clamped = torch.minimum(ids2, caps[:, None]).long()
        flat = torch.where(
            clamped >= 0,
            clamped + torch.arange(cc, device=dev)[:, None] * v,
            torch.full_like(clamped, zero_row),
        ).T.contiguous()
        t2 = table.reshape(-1, d)
        valid = clamped >= 0
        uniq = torch.unique(flat[valid.T]).numel()
        nbytes += (ids2.numel() * 4 + cc * 4
                   + uniq * d * table.element_size() + bp * cc * d * 4)
        args.append((table, ids2, caps))
        libs.append(lambda f=flat, t=t2: F.embedding(f, t).float())
        shapes.append(f"ids [{cc}, {bp}], V_pad {v} -> [{bp}, {cc}, {d}]")
    return dict(
        group="+".join(str(g.gid) for g, _ in pairs),
        kern=lambda: onehot_lookups(args),
        plain=lambda: [onehot_lookup_plain(*a) for a in args],
        lib=lambda: [f() for f in libs], bound=bound_ms(nbytes),
        shape="; ".join(shapes),
    )


def k1_searched_call(torch, eng, g, packed):
    """K1's record on a one-hot group whose bucketize members reach the
    card raw (``EngineConfig(host_bucketize=False)``): the raw [n_bz, Bp]
    plane and the host ids, the bucketize searched in K1's id read.  Its
    plain version: ``device_bucketize`` (+ LUT) joined to the host ids,
    then ``onehot_lookup_plain``.  Library: none (no single call); for
    reference, ``torch.searchsorted`` + ``F.embedding`` (the same ids but
    for NaN, which no row of this batch holds) timed beside it.  Bound:
    the raw values, host ids and caps read, each member's boundaries, the
    distinct rows selected and the f32 output written, each once."""
    import torch.nn.functional as F

    from recom_tpu_torch.ops.lookup_onehot import (
        Searched,
        onehot_lookup_plain,
        onehot_lookups,
        searched_ids_plain,
    )

    c = eng._consts[g.gid]
    require("k1_hi" in c and "raw_bz" in packed,
            f"group {g.gid} should be searched in K1's id read")
    table = eng.device_params["stacked"][str(g.gid)]
    raw = packed["raw_bz"].contiguous()
    nbz, bp = raw.shape
    host = packed["host_ids"][:, :, 0].to(torch.int32).contiguous()
    s = Searched(raw, c["k1_hi"], c["k1_counts"], c.get("k1_lut"))
    caps = c["caps"]
    cc, v, d = g.num_columns, table.shape[1], table.shape[2]
    ids = torch.minimum(torch.cat([searched_ids_plain(s), host]),
                        caps[:, None]).long()
    cols = torch.arange(cc, device=raw.device)[:, None] * v
    uniq = torch.unique((ids + cols)[ids >= 0]).numel()
    nbytes = (raw.numel() * 4 + host.numel() * 4 + cc * 4
              + int(c["k1_counts"].sum()) * 4
              + uniq * d * table.element_size() + bp * cc * d * 4)
    t2 = table.reshape(-1, d)
    hi = c["k1_hi"]

    def reference():
        bz = torch.searchsorted(hi, raw, right=True).int()
        flat = (torch.cat([bz, host]) + cols).T
        return F.embedding(flat, t2)

    return dict(
        group=g.gid, kern=lambda: onehot_lookups([(table, host, caps, s)]),
        plain=lambda: [onehot_lookup_plain(
            table, torch.cat([searched_ids_plain(s), host]), caps)],
        lib=None, reference=reference, bound=bound_ms(nbytes),
        shape=f"raw [{nbz}, {bp}] searched + ids [{cc - nbz}, {bp}], "
        f"V_pad {v} -> [{bp}, {cc}, {d}]",
    )


def searched_edge_batch(batch, g, rows: int):
    """``batch`` with the bucketize members of one-hot group ``g`` fed
    the searched route's edge values on its first rows: NaN, +-inf,
    +-0.0, subnormals, then each member's boundaries exactly (as the f32
    boundaries the card compares) and the floats just below them."""
    import numpy as np

    out = {k: np.array(v, copy=True) for k, v in batch.items()}
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40,
                         1.4e-45], np.float32)
    for i, m in enumerate(g.members[:g.n_bucketize]):
        x = out[m.column.source.field]
        x[:len(specials)] = specials
        k = int(g.boundary_counts[i])
        if k:
            hits = g.boundary_matrix[i, (np.arange(rows) * 7) % k]
            n = (len(x) - len(specials)) // 2
            hits = hits[:n]
            x[len(specials): len(specials) + len(hits)] = hits
            below = np.nextafter(hits, np.float32(-np.inf))
            x[len(specials) + len(hits): len(specials) + 2 * len(hits)] = \
                below
    return out


def k2_call(torch, eng, g, raw):
    """K2's record (K2-bf16's for a bf16 table3) for pure-bucketize group
    ``g`` of ``eng`` on its raw [C, Bp] plane: the kernel, its plain
    version and the bound (raw values, counts and boundaries read, the
    distinct rows selected at their stored width, the f32 output written).
    Library yardstick: none for f32 (no one call bucketizes and looks up);
    for bf16, ``F.embedding`` + ``.float()`` on ids found beforehand, the
    lookup alone."""
    import torch.nn.functional as F

    from recom_tpu_torch.ops.lookup_onehot import (
        onehot_bucketize_lookup,
        onehot_bucketize_lookup_plain,
    )

    c = eng._consts[g.gid]
    table = eng.device_params["stacked"][str(g.gid)]
    a = (table, raw, c["bz_lo"], c["bz_hi"], c["bz_counts"])
    cc, bp = raw.shape
    v, d = table.shape[1], table.shape[2]
    cnt = c["bz_counts"][:cc, 0].long()
    ids = torch.searchsorted(c["bz_hi"][:cc], raw, right=True)
    ids = torch.where(raw < float("inf"), torch.minimum(ids, cnt[:, None]),
                      cnt[:, None])
    flat = (ids + torch.arange(cc, device=raw.device)[:, None] * v).T
    uniq = torch.unique(flat).numel()
    nbytes = (raw.numel() * 4 + cc * 4 + int(cnt.sum()) * 4
              + uniq * d * table.element_size() + bp * cc * d * 4)
    lib = None
    if table.dtype == torch.bfloat16:
        flat, t2 = flat.contiguous(), table.reshape(-1, d)
        lib = lambda: F.embedding(flat, t2).float()
    return dict(
        group=g.gid, args=a, kern=lambda: onehot_bucketize_lookup(*a),
        plain=lambda: onehot_bucketize_lookup_plain(*a), lib=lib,
        bound=bound_ms(nbytes),
        shape=f"raw [{cc}, {bp}], V_pad {v}, {str(table.dtype)[6:]} -> "
        f"[{bp}, {cc}, {d}]",
    )


def x1_work(torch, args):
    """The bytes X1 must move for one group's arguments ``args`` (ids,
    weights, the distinct rows read at their stored width with an int8
    row's scale, and the f32 output, each once), its valid slots, and the
    valid mask and row of every slot."""
    from recom_tpu_torch.ops.quant import QuantizedTable

    table, ids, offs, _, weights, _, caps = args
    quant = isinstance(table, QuantizedTable)
    rows_t = table.q if quant else table
    row_bytes = rows_t.shape[1] * rows_t.element_size() + 4 * quant
    cc, bp, _ = ids.shape
    clamped = torch.minimum(ids, caps[:, None, None]).long()
    valid = clamped >= 0
    rows = clamped + offs.long()[:, None, None]
    uniq = torch.unique(rows[valid]).numel()
    nbytes = (ids.numel() * 4 + uniq * row_bytes
              + bp * cc * rows_t.shape[1] * 4
              + (0 if weights is None else weights.numel() * 4))
    return nbytes, int(valid.sum()), valid, rows


def x1_member(torch, eng, g, ids, weights, bp: int):
    """One gather group's share of X1's launch (or of X1-bf16's, or
    X1-int8's): its arguments, plain version, library yardstick
    (``F.embedding_bag`` with per-sample weights, missing slots at weight
    0; none for a bf16 or int8 table, since no PyTorch call pools their
    rows in f32), bytes (ids, weights, the distinct rows read at their
    stored width with an int8 row's scale, and the f32 output, each once)
    and operations (an int8 element's dequantizing product besides)."""
    import torch.nn.functional as F

    from recom_tpu_torch.ops.lookup_gather import group_pooled_plain
    from recom_tpu_torch.ops.quant import QuantizedTable

    c = eng._consts[g.gid]
    table = eng.device_params["stacked"][str(g.gid)]
    args = (table, ids, c["row_offsets"], c["codes"], weights,
            c["weighted"], c["caps"])
    quant = isinstance(table, QuantizedTable)
    rows_t = table.q if quant else table
    cc, _, ll = ids.shape
    d = rows_t.shape[1]
    nbytes, nvalid, valid, rows = x1_work(torch, args)
    safe = torch.where(valid, rows, torch.zeros_like(rows))
    w = valid.float() if weights is None else weights * valid
    bag_in = safe.permute(1, 0, 2).reshape(bp * cc, ll).contiguous()
    bag_w = w.permute(1, 0, 2).reshape(bp * cc, ll).contiguous()
    lib = None
    if rows_t.dtype == torch.float32:
        lib = lambda: F.embedding_bag(bag_in, table, mode="sum",
                                      per_sample_weights=bag_w)
    return dict(
        group=g.gid, args=args, f32=rows_t.dtype == torch.float32,
        plain=lambda: group_pooled_plain(
            table, ids, g.row_offsets, g.combiner_code, weights,
            g.weighted_cols, g.vocab_caps),
        lib=lib, nbytes=nbytes, flops=(2.0 + quant) * nvalid * d,
        rows=rows_t.shape[0],
        shape=f"ids [{cc}, {bp}, {ll}], table [{rows_t.shape[0]}, {d}] "
        f"{str(rows_t.dtype)[6:]} -> [{bp}, {cc}, {d}]",
    )


def x1_call(members):
    """X1's record: one launch for every gather group in ``members``."""
    from recom_tpu_torch.ops.lookup_gather import groups_pooled

    args = [x["args"] for x in members]
    has_lib = all(x["lib"] is not None for x in members)
    return dict(
        members=members,
        group="+".join(str(x["group"]) for x in members),
        kern=lambda: groups_pooled(args),
        plain=lambda: [x["plain"]() for x in members],
        lib=(lambda: [x["lib"]() for x in members]) if has_lib else None,
        bound=bound_ms(sum(x["nbytes"] for x in members),
                       sum(x["flops"] for x in members)),
        shape="; ".join(x["shape"] for x in members),
    )


def time_alone(torch, label: str, kern, nbytes: float) -> dict:
    """One X1 launch ``kern`` timed warm and cold, logged beside its bound
    (``nbytes`` over the HBM rate), as a "classes" entry."""
    with torch.inference_mode():
        ms = time_ms(torch, kern)
        cold = time_cold_ms(torch, kern)
    bms, by = bound_ms(nbytes)
    log(f"  X1, {label}: kernel {ms:.4f} ms warm, {cold:.4f} ms cold L2, "
        f"bound {bms:.4f} ms ({by}, share {bms / ms:.0%})")
    return dict(name=label, ms=ms, cold_ms=cold, bound_ms=bms)


def x1_largest_alone(torch, rec) -> list:
    """X1's record ``rec``'s largest-table group (model E's 2^23-row lists)
    alone in one launch: its warm and cold times and its bound, the part of
    X1 a stored dtype shrinks most.  Returns a one-entry "classes" list."""
    member = max(rec["members"], key=lambda x: x["rows"])
    alone = x1_call([member])
    return [time_alone(torch, f"group {member['group']} alone "
                       f"({member['shape']})", alone["kern"],
                       member["nbytes"])]


def x1_oneid_alone(torch, rec) -> list:
    """X1's record ``rec``'s widest group of one id with no weights (model
    E's 50 string-hash columns, or its 980 one-id columns under int8) alone
    in one launch, so its share of the launch is measured and not found by
    difference; where the group has members of both <= 128 rows (model
    E's one-hot-sized tables) and more (its string-hash tables), each
    class alone too: a small vocab's rows repeat within a tile and hit L1,
    a large one's miss.  Returns the "classes" entries."""
    from recom_tpu_torch.ops.lookup_gather import (
        X1_ONEID_F32_BELOW_D,
        group_pooled_plain,
        groups_pooled,
    )

    ones = [x for x in rec["members"]
            if x["args"][1].shape[2] == 1 and x["args"][4] is None]
    require(bool(ones), "no group of one id in X1's launch")
    member = max(ones, key=lambda x: x["args"][1].shape[0])
    args = member["args"]
    tile = ("f32 bag tile" if member["f32"]
            and args[0].shape[1] >= X1_ONEID_F32_BELOW_D else "one-id tile")
    out = [time_alone(torch, f"group {member['group']} alone, {tile} "
                      f"({member['shape']})", x1_call([member])["kern"],
                      member["nbytes"])]
    small = (args[6] < 128).nonzero()[:, 0]
    large = (args[6] >= 128).nonzero()[:, 0]
    if 0 < small.numel() < args[1].shape[0]:
        for what, sel in (("members of <= 128 rows", small),
                          ("members of > 128 rows", large)):
            sub = (args[0], args[1][sel].contiguous(), args[2][sel],
                   args[3][sel], None, args[5][sel], args[6][sel])
            kern = lambda sub=sub: groups_pooled([sub])
            with torch.inference_mode():
                got, want = kern()[0], group_pooled_plain(
                    *sub[:2], *(x.cpu().numpy() for x in sub[2:4]), None,
                    sub[5].cpu().numpy().astype(bool), sub[6].cpu().numpy())
                torch.cuda.synchronize()
            require(bool((got == want).all()), f"X1 group {member['group']}"
                    f", {what}: kernel != plain")
            out.append(time_alone(
                torch, f"group {member['group']}'s {sel.numel()} {what} "
                f"alone, {tile}", kern, x1_work(torch, sub)[0]))
    return out


def x1_oneid_f32_ab(torch, rec, name: str) -> dict:
    """X1's f32 launch ``rec`` with its one-id groups on the bag tile (A)
    and on the one-id tile at every width (B), as
    ``lookup_gather.X1_ONEID_F32_BELOW_D`` set to 0 and past any d, each
    held == the plain version and timed warm in turns A B B A (the spread:
    each arm's two readings).  Returns both arms' readings; the module's
    setting is restored."""
    from recom_tpu_torch.ops import lookup_gather

    keep = lookup_gather.X1_ONEID_F32_BELOW_D
    times = {0: [], 1 << 30: []}
    try:
        with torch.inference_mode():
            for arm in (0, 1 << 30, 1 << 30, 0):
                lookup_gather.X1_ONEID_F32_BELOW_D = arm
                outs, wants = rec["kern"](), rec["plain"]()
                torch.cuda.synchronize()
                for a, b in zip(outs, wants):
                    require(bool((a == b).all()), f"X1 at {name}, one-id "
                            f"tile below d = {arm}: kernel != plain")
                times[arm].append(time_ms(torch, rec["kern"]))
    finally:
        lookup_gather.X1_ONEID_F32_BELOW_D = keep
    bag, tile = times[0], times[1 << 30]
    log(f"X1 at {name}, f32 one-id groups on the bag tile: {bag[0]:.4f} / "
        f"{bag[1]:.4f} ms warm; on the one-id tile: {tile[0]:.4f} / "
        f"{tile[1]:.4f} ms (turns A B B A; each == plain; the port takes "
        f"the one-id tile for f32 rows of d < {keep})")
    return {"bag_tile_ms": bag, "oneid_tile_ms": tile}


def measure_forward(torch, calls):
    """Each forward kernel's records (``calls``: {kernel id: [record]}) held
    against their plain versions on the card (exactly; as bits for K1 and
    K2) and the library yardstick, then timed: warm, cold L2, host-paced,
    plain and library.  Returns {kernel id: summed results}."""
    results = {}
    as_list = lambda x: x if isinstance(x, list) else [x]
    with torch.inference_mode():
        for kid, recs in calls.items():
            require(bool(recs), f"no main-path call of {kid}")
            err = 0.0
            tot = dict(ms=0.0, cold_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                       library_ms=0.0)
            bound_by = {"bytes": 0.0, "operations": 0.0}
            for r in recs:
                outs, wants = as_list(r["kern"]()), as_list(r["plain"]())
                torch.cuda.synchronize()
                require(len(outs) == len(wants), f"{kid}: output count")
                for a, b in zip(outs, wants):
                    require(a.shape == b.shape and a.dtype == b.dtype,
                            f"{kid} group {r['group']}: shape/dtype mismatch")
                    e = float((a.double() - b.double()).abs().max()) \
                        if a.numel() else 0.0
                    require(bool((a == b).all()),
                            f"{kid} group {r['group']}: kernel != plain "
                            f"(max abs err {e})")
                    if kid.startswith(("K1", "K2")):
                        require(bool((a.view(torch.int32)
                                      == b.view(torch.int32)).all()),
                                f"{kid}: kernel != plain as bits")
                    err = max(err, e)
                ms = time_ms(torch, r["kern"])
                cold = time_cold_ms(torch, r["kern"])
                paced = time_ms(torch, r["kern"], queued=False)
                pms = time_ms(torch, r["plain"], iters=5, warmup=1)
                lms = None
                if r["lib"] is not None:
                    for ref, a in zip(as_list(r["lib"]()), outs):
                        require(torch.allclose(ref.reshape(a.shape), a,
                                               rtol=1e-5, atol=1e-6),
                                f"{kid} group {r['group']}: library "
                                "yardstick computes another function")
                    lms = time_ms(torch, r["lib"])
                    tot["library_ms"] += lms
                bms, by = r["bound"]
                bound_by[by] += bms
                tot["ms"] += ms
                tot["cold_ms"] += cold
                tot["plain_ms"] += pms
                tot["bound_ms"] += bms
                log(f"{kid} group {r['group']} ({r['shape']}): kernel "
                    f"{ms:.4f} ms warm, {cold:.4f} ms cold L2 (host-paced "
                    f"{paced:.4f} ms), plain {pms:.4f} ms, library "
                    f"{'-' if lms is None else f'{lms:.4f} ms'}, bound "
                    f"{bms:.4f} ms ({by}), exact")
            log(f"{kid} summed over {len(recs)} launch(es): kernel "
                f"{tot['ms']:.4f} ms warm, {tot['cold_ms']:.4f} ms cold, "
                f"bound {tot['bound_ms']:.4f} ms (share of bound, cold: "
                f"{tot['bound_ms'] / tot['cold_ms']:.0%})")
            has_lib = any(r["lib"] is not None for r in recs)
            results[kid] = dict(
                err=err, bound_by=max(bound_by, key=bound_by.get),
                lib=tot["library_ms"] if has_lib else None, **tot,
            )
    return results


def serve_phases(torch, model, np_params, int_rate: float):
    """Phases 2-6: serve model E and micro-1000, hold the forward kernels
    against their plain versions, and time them.  Returns the kernels'
    results, the launch counts of the counted predicts, the oracle's
    forward of the 512 batch and the two model E batches; the engines are
    freed when it returns."""
    import numpy as np

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.models import make_random_batch
    from recom_tpu_torch.models.synthetic import make_microbenchmark_model
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.ops.hash_device import (
        bucket_reciprocals,
        hash_verbatim,
        hash_verbatim_plain,
    )
    from recom_tpu_torch.ops.lookup_gather import (
        group_pooled_plain,
        groups_pooled,
    )
    from recom_tpu_torch.ops.lookup_onehot import (
        bucket_bounds,
        onehot_bucketize_lookup,
        onehot_bucketize_lookup_plain,
        onehot_lookup,
        onehot_lookup_plain,
    )
    from recom_tpu_torch.oracle import OracleModel
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.runtime.wire import _plan, wire_layout
    from recom_tpu_torch.runtime.wire import unpack_blob
    from recom_tpu_torch.utils.params import init_model_params

    dev = torch.device("cuda")
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(model, EngineConfig(), params=np_params, device="cuda")
    torch.cuda.synchronize()
    log(f"Engine(model E, EngineConfig(), device='cuda'): "
        f"{time.perf_counter() - t:.1f} s, groups "
        + "; ".join(
            f"gid {g.gid}: {g.num_columns} cols d={g.dim} "
            f"ragged={g.ragged} onehot={g.pallas_vocab is not None} "
            f"rows={g.stacked_rows}"
            for g in eng.compiled.groups
        ))
    log(f"device memory after build: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # ---- phase 2: each kernel vs its plain version at main-path shapes ----
    batch_big = make_random_batch(model, 2048, seed=1)
    prepared = eng.prepare(batch_big)
    require(prepared.batch_padded == 2048, "batch 2048 bucket")
    bp, rowlens, wsig = (prepared.batch_padded, prepared.rowlens,
                         prepared.wsig)
    require(bool(wsig) and all(ws or wd for ws, wd in wsig[1:]),
            f"model E at 2048 should take device hashing, wsig={wsig}")
    blob = eng.to_device(prepared)["blob"]
    from recom_tpu_torch.runtime.wire import unpack_blob

    with torch.inference_mode():
        arrays = unpack_blob(eng.compiled, blob, bp, rowlens, wsig)
    layout = wire_layout(eng.compiled, bp, tuple(rowlens), True, tuple(wsig))
    by_key = {(v.gid, v.name): v for v in layout.views}
    plans = _plan(eng.compiled)

    def view(gid, name, dtype):
        v = by_key[(gid, name)]
        return blob[v.offset: v.offset + v.nbytes].view(dtype).reshape(v.shape)

    calls = {"K1": [], "K2": [], "X1": [], "X2": []}   # per-call records
    x1_groups = []          # model E's gather groups, one launch of X1
    k1_groups = []          # its one-hot groups, one launch of K1
    for g, packed in zip(eng.compiled.groups, arrays["groups"]):
        ids, weights = eng.group_ids(g, packed)
        if g.pallas_vocab is not None:
            k1_groups.append((g, ids))
        else:
            x1_groups.append(x1_member(torch, eng, g, ids, weights, bp))
        gi = g.gid
        ws, wd = wsig[gi]
        p = plans[gi]
        if ws or wd:
            name = "str" if ws else "split"
            raw = view(g.gid, f"{name}_raw", torch.uint8)
            widths = view(g.gid, f"{name}_w", torch.int32)
            if ws:
                bk_np, dl, wbk, rl = p.str_buckets, None, ws, 1
            else:
                bk_np, wbk, rl = p.fast_buckets, wd, rowlens[gi]
                dl = torch.as_tensor(p.fast_delims_np, device=dev)
            bk = torch.as_tensor(bk_np, device=dev)
            rc = torch.as_tensor(bucket_reciprocals(bk_np), device=dev)
            n = raw.shape[0]
            kern = lambda a=(raw, widths, bk, rc, dl, bp, wbk, rl): (
                hash_verbatim(*a))
            plain = lambda a=(raw, widths, bk, dl, bp, wbk, rl): (
                hash_verbatim_plain(*a))
            wsum = int(widths.long().sum())
            nbytes = wsum * bp + n * (4 + 8 + 8 + 1) + n * bp * rl * 4
            int_ops = x2_int_ops(torch, raw, widths, dl, bp, wbk, rl)
            calls["X2"].append(dict(
                group=g.gid, kern=kern, plain=plain, lib=None,
                bound=bound_ms(nbytes, int_ops=int_ops, int_rate=int_rate),
                shape=f"{n} cols x {bp} rows, width bucket {wbk}, L={rl}, "
                f"{int_ops / 1e6:.2f} M int ops",
            ))

    # X1's one launch serves every gather group of the path, K1's every
    # one-hot group
    calls["X1"].append(x1_call(x1_groups))
    calls["K1"].append(k1_call(torch, eng, k1_groups, bp))

    # K1 and X2 on their edge inputs (exact, as bits for K1)
    with torch.inference_mode():
        bk_np = np.asarray(EDGE_BUCKETS, np.int64)
        rc = torch.from_numpy(bucket_reciprocals(bk_np)).to(dev)
        for case in x2_edge_cases():
            a = [torch.from_numpy(case["raw"]).to(dev),
                 torch.from_numpy(case["widths"]).to(dev),
                 torch.from_numpy(bk_np).to(dev)]
            dl = (None if case["delim"] is None else torch.full(
                (len(bk_np),), case["delim"], dtype=torch.uint8, device=dev))
            rest = (case["bp"], case["wbk"], case["rowlen"])
            got = hash_verbatim(*a, rc, dl, *rest)
            want = hash_verbatim_plain(*a, dl, *rest)
            torch.cuda.synchronize()
            require(got.shape == want.shape and bool((got == want).all()),
                    f"X2 edge case ({case['name']}): kernel != plain")
            log(f"X2 edge case ({case['name']}; width bucket {case['wbk']}, "
                f"itemsizes {case['widths'].tolist()}): kernel == plain")
        for cc, v, bb, d in K1_EDGES:
            t3, ids_np, caps_np = k1_edge_case(cc, v, d, bb, seed=d)
            a = (torch.from_numpy(t3).to(dev), torch.from_numpy(ids_np).to(dev),
                 torch.from_numpy(caps_np).to(dev))
            got, want = onehot_lookup(*a), onehot_lookup_plain(*a)
            torch.cuda.synchronize()
            require(got.shape == want.shape == (bb, cc, d) and bool(
                (got.view(torch.int32) == want.view(torch.int32)).all()),
                f"K1 edge case C={cc} V_pad={t3.shape[1]} Bp={bb} d={d}: "
                "kernel != plain")
        log(f"K1 edge cases ((C, V, Bp, d) in {K1_EDGES}: ragged tiles, V_pad "
            "128 and 2304, an all-missing column, ids past caps and below "
            "-1, -0.0 and NaN rows): kernel == plain bit for bit")
        k1_group_cases(torch)
        # X1: every (d, L) pair, unweighted and weighted, through launches
        # of 8 groups each (float and float4 rows, 1 to 32 lanes a bag,
        # mixed in one launch); == with NaN where the plain version has it
        x1_edge = []
        for d in X1_EDGE_D:
            for ll in X1_EDGE_L:
                for weighted in (False, True):
                    tb, ids_np, offs, caps_np, codes, w_np, wc = x1_edge_case(
                        d, ll, seed=10 * d + ll)
                    x1_edge.append(((d, ll, weighted), (
                        torch.from_numpy(tb).to(dev),
                        torch.from_numpy(ids_np).to(dev), offs, codes,
                        torch.from_numpy(w_np).to(dev) if weighted else None,
                        wc if weighted else np.zeros(len(wc), bool), caps_np,
                    )))
        before = kernels.launches["X1"]
        got_all = groups_pooled([a for _, a in x1_edge])
        require(kernels.launches["X1"] - before == -(-len(x1_edge) // 8),
                "X1 edge cases: one launch per 8 groups")
        for (key, a), got in zip(x1_edge, got_all):
            want = group_pooled_plain(*a)
            torch.cuda.synchronize()
            same = (got == want) | (got.isnan() & want.isnan())
            require(got.shape == want.shape and bool(same.all()),
                    f"X1 edge case (d, L, weighted) = {key}: kernel != plain")
        log(f"X1 edge cases (d in {X1_EDGE_D} x L in {X1_EDGE_L}, unweighted "
            "and weighted; C = 6, Bp = 100; all-missing and zero-weight "
            "bags, ids past caps and below -1, -0.0 / NaN / +-inf rows): "
            f"kernel == plain, {len(x1_edge)} groups in "
            f"{kernels.launches['X1'] - before} launches")
        # K2: ragged tiles, d off and on the float4 path, V_pad 128, 256
        # and 384 (not a power of two), count 0 and V_pad - 1, repeated,
        # -inf-only and merged boundaries
        for v_pad in (128, 256, 384):
            for d in (1, 3, 8, 32):
                bm, cn, t3, raw_np = k2_edge_case(45, v_pad, d, 100,
                                                  seed=v_pad + d)
                a = (torch.from_numpy(t3).to(dev),
                     torch.from_numpy(raw_np).to(dev),
                     *(torch.from_numpy(x).to(dev) for x in bucket_bounds(
                         bm, cn, v_pad, t3.shape[0])))
                got = onehot_bucketize_lookup(*a)
                want = onehot_bucketize_lookup_plain(*a)
                torch.cuda.synchronize()
                require(got.shape == want.shape and bool(
                    (got.view(torch.int32) == want.view(torch.int32)).all()),
                    f"K2 edge case V_pad={v_pad} d={d}: kernel != plain")
        log("K2 edge cases (C = 45, Bp = 100, V_pad 128 / 256 / 384, d 1 / 3 "
            "/ 8 / 32; counts 0 and V_pad - 1, repeated, -inf-only and "
            "merged boundaries; NaN, +-inf, +-0.0, boundaries and the floats "
            "below them): kernel == plain bit for bit")

    # K2's path: the microbenchmark model at 1000 columns, raw floats on
    # the card (wire blob, host_bucketize=False)
    t = time.perf_counter()
    micro = make_microbenchmark_model(1000, random_boundary=True, seed=0)
    micro_params = init_model_params(micro)
    eng_mb = Engine(micro, EngineConfig(host_bucketize=False),
                    params=micro_params, device="cuda")
    torch.cuda.synchronize()
    log(f"Engine(micro-1000, host_bucketize=False): "
        f"{time.perf_counter() - t:.1f} s, groups " + "; ".join(
            f"gid {g.gid}: {g.num_columns} cols V_pad={g.pallas_vocab}"
            for g in eng_mb.compiled.groups))
    mb_big = make_random_batch(micro, 2048, seed=1)
    prep_mb = eng_mb.prepare(mb_big)
    require(prep_mb.batch_padded == 2048, "micro batch 2048 bucket")
    with torch.inference_mode():
        mb_arrays = unpack_blob(eng_mb.compiled,
                                eng_mb.to_device(prep_mb)["blob"], 2048,
                                prep_mb.rowlens, prep_mb.wsig)
    for g, packed in zip(eng_mb.compiled.groups, mb_arrays["groups"]):
        c = eng_mb._consts[g.gid]
        require("bz_hi" in c and "raw_bz" in packed,
                f"micro group {g.gid} should take K2")
        table = eng_mb.device_params["stacked"][str(g.gid)]
        raw = packed["raw_bz"].contiguous()
        a = (table, raw, c["bz_lo"], c["bz_hi"], c["bz_counts"])
        cc, bp_mb = raw.shape
        require(raw.dtype == torch.float32 and bp_mb == 2048
                and cc == g.num_columns, "raw_bz is f32 [n_bz, Bp]")
        # the specials, in a copy: NaN, +-inf, -0.0, +0.0, each column's
        # boundaries exactly, and the float just below each
        cnt = c["bz_counts"][:cc, 0].long()
        hi = c["bz_hi"][:cc]
        special = raw.clone()
        special[:, 0:5] = torch.tensor(
            [float("nan"), float("inf"), float("-inf"), -0.0, 0.0],
            device=dev)
        pick = (torch.arange(64, device=dev)[None, :] * 7) % cnt[:, None]
        hits = hi.gather(1, pick)                        # [C, 64]
        special[:, 5:69] = hits
        special[:, 69:133] = torch.nextafter(
            hits, torch.full_like(hits, float("-inf")))
        sa = (table, special) + a[2:]
        got, want = onehot_bucketize_lookup(*sa), \
            onehot_bucketize_lookup_plain(*sa)
        torch.cuda.synchronize()
        require(bool((got.view(torch.int32) == want.view(torch.int32)).all()),
                f"K2 group {g.gid}: kernel != plain on the special values")
        log(f"K2 group {g.gid}: kernel == plain bit for bit on NaN, +-inf, "
            "-0.0, +0.0, 64 boundary values per column and the floats "
            "below them")
        calls["K2"].append(k2_call(torch, eng_mb, g, raw))

    results = measure_forward(torch, calls)
    results["X1"]["classes"] = (x1_largest_alone(torch, calls["X1"][0])
                                + x1_oneid_alone(torch, calls["X1"][0]))
    results["X1"]["oneid_f32_ab"] = x1_oneid_f32_ab(torch, calls["X1"][0],
                                                    "model E")

    # ---- phase 3: the main path, counted --------------------------------
    # the first request of a signature runs the forward eagerly and
    # captures its program; the counted requests are replays of it
    batch_small = make_random_batch(model, 512, seed=2)
    eng.predict(batch_small, return_pooled=True)
    eng.predict(batch_big)
    torch.cuda.synchronize()
    programs = eng.stats["compiles"]
    kernels.reset_launches()
    out = eng.predict(batch_small, return_pooled=True)
    torch.cuda.synchronize()
    counts_512 = dict(kernels.launches)
    log(f"launches in predict(batch 512): {counts_512}")
    require_launches(counts_512, ("K1", "X1", "X2"), "model E",
                     exactly={"X1": 1})
    require(out["output"].shape == (512, 1), "output shape")
    require(bool(np.isfinite(out["output"]).all()), "finite outputs")

    t = time.perf_counter()
    ref = OracleModel(model, np_params).forward(batch_small)
    log(f"oracle forward (batch 512): {time.perf_counter() - t:.1f} s")
    check_pooled(ref, out, "model E, batch 512")

    kernels.reset_launches()
    out_big, seen = profiled_kernels(torch, lambda: eng.predict(batch_big))
    counts_2048 = dict(kernels.launches)
    log(f"launches in predict(batch 2048): {counts_2048}; the profiler's "
        f"kernels of csrc/ in that replay: {seen}")
    require_launches(counts_2048, ("K1", "X1", "X2"), "model E",
                     exactly={"K1": 1, "X1": 1, "X2": 3})
    require(seen == {"K1": 1, "X1": 1, "X2": 3},
            f"model E at 2048: the profiler saw {seen} in the replay")
    require(eng.stats["compiles"] == programs == len(eng._programs) == 2,
            f"the counted requests were not replays: {eng.stats}")
    require(out_big["output"].shape == (2048, 1)
            and bool(np.isfinite(out_big["output"]).all()),
            "batch 2048 output")

    # ---- phase 4: predict latency and where it goes ----------------------
    latency(torch, eng, "model E", ((512, batch_small), (2048, batch_big)))

    # ---- phase 5: model E with device bucketize, searched in K1's id read -
    t = time.perf_counter()
    eng_bz = Engine(model, EngineConfig(host_bucketize=False),
                    params=np_params, device="cuda")
    torch.cuda.synchronize()
    log(f"Engine(model E, host_bucketize=False): "
        f"{time.perf_counter() - t:.1f} s")
    gi_mixed, g_mixed = [(i, g) for i, g in enumerate(eng_bz.compiled.groups)
                         if g.pallas_vocab is not None][0]
    require(0 < g_mixed.n_bucketize < g_mixed.num_columns
            and "k1_hi" in eng_bz._consts[g_mixed.gid],
            "model E's one-hot group: bucketize and int-hash members, the "
            "bucketize searched in K1's id read")
    t = time.perf_counter()
    ref_big = OracleModel(model, np_params).forward(batch_big)
    log(f"oracle forward (batch 2048): {time.perf_counter() - t:.1f} s")
    edge = searched_edge_batch(batch_small, g_mixed, 512)
    ref_edge = OracleModel(model, np_params).forward(edge)
    counts_bz = {}
    for bs, b, r in ((512, batch_small, ref), (2048, batch_big, ref_big),
                     (512, edge, ref_edge)):
        eng_bz.predict(b)                    # the signature's capture
        kernels.reset_launches()
        out_bz = eng_bz.predict(b, return_pooled=True)
        torch.cuda.synchronize()
        counts_bz[bs] = dict(kernels.launches)
        require_launches(counts_bz[bs], ("K1", "X1", "X2"),
                         "model E, device bz", exactly={"K1": 1, "X1": 1})
        check_pooled(r, out_bz, f"model E, host_bucketize=False, batch {bs}"
                     + (" (NaN, +-inf, +-0.0, subnormal and boundary "
                        "values)" if b is edge else ""))
    log(f"launches in a replayed predict, host_bucketize=False: {counts_bz}")
    # the replay at 2048 holds no torch comparison (device_bucketize's) and
    # no reduction; its device ops beside the default config's replay's
    _, names_bz = profiled_ops(torch, lambda: eng_bz.predict(batch_big))
    _, names_e = profiled_ops(torch, lambda: eng.predict(batch_big))
    torch_cmp = [n for n in names_bz if "ompare" in n
                 or ("reduce_kernel" in n and n not in names_e)]
    require(not torch_cmp, f"model E, host_bucketize=False: the replay "
            f"holds torch comparisons or reductions: {torch_cmp[:3]}")
    log(f"model E replay at 2048: {sum(names_bz.values())} device ops under "
        f"host_bucketize=False, {sum(names_e.values())} in the default "
        f"config; no torch comparison or reduction; ops the default's "
        f"lacks: {sorted(set(names_bz) - set(names_e))}")
    with torch.inference_mode():
        prep_bz = eng_bz.prepare(batch_big)
        arrays_bz = unpack_blob(eng_bz.compiled,
                                eng_bz.to_device(prep_bz)["blob"], 2048,
                                prep_bz.rowlens, prep_bz.wsig)
        searched = k1_searched_call(torch, eng_bz, g_mixed,
                                    arrays_bz["groups"][gi_mixed])
        searched_res = measure_forward(torch, {"K1": [searched]})["K1"]
        searched_res["reference_ms"] = time_ms(torch, searched["reference"])
    searched_res["launches"] = counts_bz[2048]["K1"]
    log(f"K1 searched (model E, host_bucketize=False, 2048): "
        f"{searched_res['ms']:.4f} ms warm; torch.searchsorted + "
        f"F.embedding for reference {searched_res['reference_ms']:.4f} ms")
    latency(torch, eng_bz, "model E, host_bucketize=False",
            ((512, batch_small), (2048, batch_big)))
    log(f"peak device memory (two model E engines): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- phase 6: the microbenchmark path, K2 only, counted ---------------
    t = time.perf_counter()
    ref_mb = OracleModel(micro, micro_params).forward(mb_big)
    log(f"oracle forward (micro-1000, batch 2048): "
        f"{time.perf_counter() - t:.1f} s")
    kernels.reset_launches()
    out_mb = eng_mb.predict(mb_big, return_pooled=True)
    torch.cuda.synchronize()
    counts_mb = dict(kernels.launches)
    log(f"launches in predict(micro-1000, batch 2048): {counts_mb}")
    require_launches(counts_mb, ("K2",), "micro-1000", exactly={"K2": 2})
    check_micro(ref_mb, out_mb, 2048)
    latency(torch, eng_mb, "micro-1000, host_bucketize=False",
            ((2048, mb_big),))
    mb_batches = [mb_big] + [make_random_batch(micro, 2048, seed=10 + i)
                             for i in range(4)]
    bench = eng_mb.benchmark(mb_batches, iters=20, warmup=3)
    log(f"Engine.benchmark(micro-1000, batch 2048, 20 steps over 4 "
        f"batches): latency_ms {bench['latency_ms']:.4f}, examples_per_s "
        f"{bench['examples_per_s']:.0f} (H2D + device forward)")
    report = eng_mb.stats_report()
    log(f"stats_report: programs_compiled {report['programs_compiled']}, "
        f"backends {[g['backend'] for g in report['groups']]}")

    eng_st = Engine(micro, EngineConfig(wire_pack=False),
                    params=micro_params, device="cuda")
    mb_small = make_random_batch(micro, 512, seed=3)
    ref_st = OracleModel(micro, micro_params).forward(mb_small)
    kernels.reset_launches()
    out_st = eng_st.predict(mb_small, return_pooled=True)
    torch.cuda.synchronize()
    counts_st = dict(kernels.launches)
    log(f"launches in predict(micro-1000, batch 512), wire_pack=False: "
        f"{counts_st}")
    require_launches(counts_st, ("K2",), "micro-1000 structured",
                     exactly={"K2": 2})
    check_micro(ref_st, out_st, 512)
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")

    return dict(results=results, counts_2048=counts_2048,
                counts_mb=counts_mb, ref=ref, batch_small=batch_small,
                searched=searched_res,
                batch_big=batch_big, out_512=out, out_2048=out_big,
                groups=group_layout(eng.compiled))


def group_layout(compiled):
    """Each group's layout: (dim, ragged, one-hot vocab, stacked rows, its
    members' tables and row offsets)."""
    return [(g.dim, g.ragged, g.pallas_vocab, g.stacked_rows,
             tuple((m.table, m.row_offset) for m in g.members))
            for g in compiled.groups]


def free_engines() -> None:
    gc.collect()
    import torch

    torch.cuda.empty_cache()


def stored_records(torch, eng, batch, k1_kid: str, x1_kid: str):
    """The lookup kernels' records at ``eng``'s path shapes for ``batch``:
    ``k1_kid`` once for every one-hot group (None: the engine has none),
    ``x1_kid`` once for every gather group (one launch)."""
    from recom_tpu_torch.runtime.wire import unpack_blob

    prepared = eng.prepare(batch)
    bp = prepared.batch_padded
    with torch.inference_mode():
        arrays = unpack_blob(eng.compiled, eng.to_device(prepared)["blob"],
                             bp, prepared.rowlens, prepared.wsig)
    calls, members, onehot = {}, [], []
    for g, packed in zip(eng.compiled.groups, arrays["groups"]):
        ids, weights = eng.group_ids(g, packed)
        if g.pallas_vocab is not None:
            require(k1_kid is not None, f"unexpected one-hot group {g.gid}")
            onehot.append((g, ids))
        else:
            members.append(x1_member(torch, eng, g, ids, weights, bp))
    if onehot:
        calls[k1_kid] = [k1_call(torch, eng, onehot, bp)]
    calls[x1_kid] = [x1_call(members)]
    return calls


def check_pooled(ref, out, what: str, cols: int = 1000) -> None:
    """Every pooled column == the oracle's, the output within rtol 1e-4 /
    atol 1e-5."""
    import numpy as np

    require(len(ref["pooled"]) == cols, f"{cols} pooled columns")
    bad = [c for c, r in ref["pooled"].items()
           if not np.array_equal(out["pooled"][c], r)]
    require(not bad, f"{what}: pooled outputs differ from the oracle: "
            f"{bad[:5]}")
    np.testing.assert_allclose(out["output"], ref["output"], rtol=1e-4,
                               atol=1e-5)
    log(f"{what}: pooled outputs of all {cols} columns == oracle; output "
        "within rtol 1e-4 / atol 1e-5 (max abs diff "
        f"{float(np.abs(out['output'] - ref['output']).max()):.3g})")


def imported_phase(torch, model, np_params, served) -> None:
    """Model E written as a feature-column GraphDef (``model_graphdef``),
    imported by the port's importer (strict), served at 512 and 2048 with
    model E's params: model E's four groups, K1 1, X1 1 and X2 3 a
    predict, pooled == the oracle and outputs == the native engine's."""
    import numpy as np

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.importers import import_tf_graphdef
    from recom_tpu_torch.ir.serde import model_to_json
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.runtime.executor import Engine

    t = time.perf_counter()
    data = model_graphdef(model)
    t_write = time.perf_counter() - t
    t = time.perf_counter()
    imported, weights = import_tf_graphdef(data, tower=model.tower,
                                           name=model.name)
    t_import = time.perf_counter() - t
    log(f"model E as a GraphDef: {len(data) / 2**20:.2f} MiB written in "
        f"{t_write:.3f} s, imported (strict) in {t_import:.3f} s on the "
        f"host; {len(imported.embedding_columns)} embedding columns, "
        f"{len(imported.tables)} VariableV2 tables (no values in the graph)")
    require(not weights and model_to_json(imported) == model_to_json(model),
            "the imported spec is not model E's")
    t = time.perf_counter()
    eng = Engine(imported, EngineConfig(), params=np_params, device="cuda")
    torch.cuda.synchronize()
    log(f"Engine(imported model E, EngineConfig()): "
        f"{time.perf_counter() - t:.1f} s")
    require(group_layout(eng.compiled) == served["groups"]
            and len(served["groups"]) == 4,
            "imported model E does not lower to model E's four groups")
    for bs, batch, want in ((512, served["batch_small"], served["out_512"]),
                            (2048, served["batch_big"], served["out_2048"])):
        kernels.reset_launches()
        out = eng.predict(batch, return_pooled=bs == 512)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        require_launches(counts, ("K1", "X1", "X2"),
                         f"imported model E, batch {bs}",
                         exactly={"K1": 1, "X1": 1, "X2": 3})
        require(np.array_equal(out["output"], want["output"]),
                f"imported model E, batch {bs}: output != the native "
                "engine's")
        if bs == 512:
            check_pooled(served["ref"], out, "imported model E, batch 512")
        log(f"imported model E, batch {bs}: launches {counts}; output == "
            "the native model E engine's")
    latency(torch, eng, "imported model E",
            ((512, served["batch_small"]), (2048, served["batch_big"])))
    del eng
    free_engines()


def stored_phases(torch, model, np_params, served):
    """Model E with bf16 and with int8 tables, and micro-1000 with bf16
    tables under host_bucketize=False: launch counts, pooled == the
    oracle on each engine's export (the stored values as f32), latency,
    and each variant against its plain version and timed at the path's
    shapes at batch 2048.  Returns {variant: results}, with launches."""
    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.models import make_random_batch
    from recom_tpu_torch.models.synthetic import make_microbenchmark_model
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.ops.quant import QuantizedTable
    from recom_tpu_torch.oracle import OracleModel
    from recom_tpu_torch.runtime.checkpoint import export_params
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.runtime.wire import unpack_blob
    from recom_tpu_torch.utils.params import init_model_params

    small, big = served["batch_small"], served["batch_big"]
    results = {}
    for dtype, k1, x1, want in (
            ("bfloat16", "K1-bf16", "X1-bf16",
             {"K1-bf16": 1, "X1-bf16": 1, "X2": 3}),
            ("int8", None, "X1-int8", {"X1-int8": 1, "X2": 3})):
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(model, EngineConfig(table_dtype=dtype), params=np_params,
                     device="cuda")
        torch.cuda.synchronize()
        stored = 0
        for v in eng.device_params["stacked"].values():
            for x in (v if isinstance(v, QuantizedTable) else (v,)):
                stored += x.numel() * x.element_size()
        log(f"Engine(model E, table_dtype={dtype!r}): "
            f"{time.perf_counter() - t:.1f} s, {stored / 1e9:.3f} GB of "
            "tables on the card, groups " + "; ".join(
                f"gid {g.gid}: {g.num_columns} cols d={g.dim} "
                f"onehot={g.pallas_vocab is not None}"
                for g in eng.compiled.groups))
        counted = {}
        for bs, batch in ((512, small), (2048, big)):
            kernels.reset_launches()
            out = eng.predict(batch, return_pooled=bs == 512)
            torch.cuda.synchronize()
            counted[bs] = dict(kernels.launches)
            log(f"launches in predict(batch {bs}), {dtype}: {counted[bs]}")
            require_launches(counted[bs], tuple(want), f"model E {dtype}",
                             exactly=want)
            if bs == 512:
                t = time.perf_counter()
                ref = OracleModel(model, export_params(eng)).forward(small)
                log(f"export_params + oracle forward (batch 512): "
                    f"{time.perf_counter() - t:.1f} s")
                check_pooled(ref, out, f"model E {dtype}, batch 512, against "
                             "the oracle on the engine's export")
        latency(torch, eng, f"model E, {dtype}", ((512, small), (2048, big)))
        recs = stored_records(torch, eng, big, k1, x1)
        res = measure_forward(torch, recs)
        res[x1]["classes"] = (x1_largest_alone(torch, recs[x1][0])
                              + x1_oneid_alone(torch, recs[x1][0]))
        for kid in res:
            results[kid] = dict(res[kid], launches=counted[2048][kid])
        log(f"peak device memory (model E, {dtype}): "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del eng, out, ref
        free_engines()

    # micro-1000 with bf16 tables, raw floats on the card: K2-bf16
    micro = make_microbenchmark_model(1000, random_boundary=True, seed=0)
    eng = Engine(micro, EngineConfig(table_dtype="bfloat16",
                                     host_bucketize=False),
                 params=init_model_params(micro), device="cuda")
    mb = make_random_batch(micro, 2048, seed=1)
    kernels.reset_launches()
    out = eng.predict(mb, return_pooled=True)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    log(f"launches in predict(micro-1000, bf16, batch 2048): {counts}")
    require_launches(counts, ("K2-bf16",), "micro-1000 bf16",
                     exactly={"K2-bf16": 2})
    check_micro(OracleModel(micro, export_params(eng)).forward(mb), out, 2048)
    prep = eng.prepare(mb)
    with torch.inference_mode():
        arrays = unpack_blob(eng.compiled, eng.to_device(prep)["blob"], 2048,
                             prep.rowlens, prep.wsig)
    recs = []
    for g, packed in zip(eng.compiled.groups, arrays["groups"]):
        require(eng.device_params["stacked"][str(g.gid)].dtype
                == torch.bfloat16, "micro-1000 tables in bf16")
        recs.append(k2_call(torch, eng, g, packed["raw_bz"].contiguous()))
    res = measure_forward(torch, {"K2-bf16": recs})
    results["K2-bf16"] = dict(res["K2-bf16"], launches=counts["K2-bf16"])
    del eng, out
    free_engines()
    return results


def bf16_specials(torch, t, seed: int):
    """An f32 table as bf16 (rounded to nearest even), a tenth of its
    elements first set to ties at bf16's rounding point (low half 0x8000)
    and some elements then set to bf16's -0.0 and subnormals (0x8000,
    0x0001, 0x807F).  NaN and +-inf stay where the f32 table has them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.array(t, np.float32)
    bits = t.view(np.uint32)
    tie = rng.random(t.shape) < 0.1
    bits[tie] = (bits[tie] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    out = torch.from_numpy(t).to(torch.bfloat16)
    b16 = out.view(torch.int16).view(-1)
    n = b16.numel()
    for k, pat in enumerate((-32768, 0x0001, -32641)):
        b16[k:n:11 + 2 * k] = pat
    return out


def int8_edges(torch, t, seed: int):
    """An f32 table with its rows scaled over 12 orders of magnitude
    (e^-14 .. e^14), row 1 zero (scale 0) and row 2 of one value (every q
    at -127), as a QuantizedTable."""
    import numpy as np

    from recom_tpu_torch.ops.quant import QuantizedTable, quantize_rows_int8

    rng = np.random.default_rng(seed)
    t = np.array(t, np.float32) * np.exp(
        rng.uniform(-14, 14, (t.shape[0], 1))).astype(np.float32)
    t[1] = 0.0
    t[2] = -0.75
    q, s = quantize_rows_int8(t)
    return QuantizedTable(torch.from_numpy(q), torch.from_numpy(s))


# the variants' edge widths and bag lengths: d off (1, 3) the vector
# units, on four-element units only (12) and on the 16-byte units of bf16
# and int8 (8, 32, 64); L = 1 (its own path) to 128
VARIANT_EDGE_D = (1, 3, 8, 12, 32, 64)
VARIANT_EDGE_L = (1, 2, 33, 128)


def variant_edges(torch) -> None:
    """K1-bf16, K2-bf16, X1-bf16 and X1-int8 against their plain versions
    on edge inputs: ragged tiles, bf16 rows holding -0.0, NaN, +-inf,
    subnormals and rounding ties, int8 rows at +-127, zero rows with scale
    0 and scales over 12 orders of magnitude, d in VARIANT_EDGE_D, L in
    VARIANT_EDGE_L, weighted and unweighted columns under all three
    combiners.  K1 and K2 bit for bit; X1 with ==, NaN where the plain
    version has it."""
    import numpy as np

    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.ops.lookup_gather import (
        X1_ONEID_F32_BELOW_D,
        _x1_group,
        group_pooled_plain,
        groups_pooled,
    )
    from recom_tpu_torch.ops.lookup_onehot import (
        bucket_bounds,
        onehot_bucketize_lookup,
        onehot_bucketize_lookup_plain,
        onehot_lookup,
        onehot_lookup_plain,
    )
    from recom_tpu_torch.ops.quant import QuantizedTable

    dev = torch.device("cuda")
    bits = lambda x: x.view(torch.int32)
    with torch.inference_mode():
        for cc, v, bb, d in K1_EDGES + ((45, 101, 100, 12),):
            t3, ids_np, caps_np = k1_edge_case(cc, v, d, bb, seed=d,
                                               specials=False)
            t3b = bf16_specials(torch, t3, seed=d)
            # whole vocab rows of NaN, +inf and -inf
            t3b.view(torch.int16)[:, 0::15] = 0x7FC1
            t3b.view(torch.int16)[:, 5::15] = 0x7F80
            t3b.view(torch.int16)[:, 10::15] = -128
            a = (t3b.to(dev), torch.from_numpy(ids_np).to(dev),
                 torch.from_numpy(caps_np).to(dev))
            before = kernels.launches["K1-bf16"]
            got, want = onehot_lookup(*a), onehot_lookup_plain(*a)
            torch.cuda.synchronize()
            require(kernels.launches["K1-bf16"] == before + 1
                    and got.dtype == torch.float32
                    and bool((bits(got) == bits(want)).all()),
                    f"K1-bf16 edge case C={cc} V_pad={t3.shape[1]} Bp={bb} "
                    f"d={d}: kernel != plain")
        log(f"K1-bf16 edge cases ((C, V, Bp, d) in {K1_EDGES} and (45, 101, "
            "100, 12); bf16 rows of -0.0, NaN, +-inf, subnormals, rounding "
            "ties): kernel == plain bit for bit")
        for v_pad in (128, 256, 384):
            for d in VARIANT_EDGE_D:
                bm, cn, t3, raw_np = k2_edge_case(45, v_pad, d, 100,
                                                  seed=v_pad + d)
                t3b = bf16_specials(torch, t3, seed=v_pad + d)
                t3b.view(torch.int16)[:, 3::7] = 0x7FC1
                t3b.view(torch.int16)[:, 4::7] = -128
                a = (t3b.to(dev), torch.from_numpy(raw_np).to(dev),
                     *(torch.from_numpy(x).to(dev) for x in bucket_bounds(
                         bm, cn, v_pad, t3.shape[0])))
                got = onehot_bucketize_lookup(*a)
                want = onehot_bucketize_lookup_plain(*a)
                torch.cuda.synchronize()
                require(bool((bits(got) == bits(want)).all()),
                        f"K2-bf16 edge case V_pad={v_pad} d={d}: kernel != "
                        "plain")
        log(f"K2-bf16 edge cases (C = 45, Bp = 100, V_pad 128 / 256 / 384, d "
            f"in {VARIANT_EDGE_D}; K2's edge boundary sets and raw values; "
            "bf16 rows of -0.0, NaN, -inf, subnormals, ties): kernel == "
            "plain bit for bit")
        for dtype, kid in (("f32", "X1"), ("bf16", "X1-bf16"),
                           ("int8", "X1-int8")):
            def stored(tb, seed):
                if dtype == "f32":
                    return torch.from_numpy(tb).to(dev)
                if dtype == "bf16":
                    return bf16_specials(torch, tb, seed).to(dev)
                qt = int8_edges(torch, tb, seed)
                return QuantizedTable(qt.q.to(dev), qt.scale.to(dev))

            # each d's 8 bag groups and 8 one-id groups in two calls, 5 + 2
            # and 3 + 6 groups: a launch puts its bag groups first, so the
            # first call is one launch of both tiles and the second two
            # (8 + 1 groups), the first of them mixed
            calls = []
            for d in VARIANT_EDGE_D:
                bags = []
                for ll in VARIANT_EDGE_L:
                    for weighted in (False, True):
                        seed = 10 * d + ll
                        tb, ids_np, offs, caps_np, codes, w_np, wc = \
                            x1_edge_case(d, ll, seed=seed,
                                         specials=dtype != "int8")
                        bags.append(((d, ll, weighted), (
                            stored(tb, seed),
                            torch.from_numpy(ids_np).to(dev), offs, codes,
                            torch.from_numpy(w_np).to(dev) if weighted
                            else None,
                            wc if weighted else np.zeros(len(wc), bool),
                            caps_np)))
                ones = []
                for k in range(8):
                    seed = 100 * d + k
                    tb, ids_np, offs, caps_np, codes, _, wc = x1_oneid_case(
                        d, seed=seed, specials=dtype != "int8")
                    ones.append(((d, 1, f"one-id {k}"), (
                        stored(tb, seed), torch.from_numpy(ids_np).to(dev),
                        offs, codes, None, wc, caps_np)))
                calls += [bags[:5] + ones[:2], bags[5:] + ones[2:]]
            oneid = [_x1_group(*a)[0]["oneid"] for call in calls
                     for key, a in call if str(key[2]).startswith("one-id")]
            want = [dtype != "f32" or d < X1_ONEID_F32_BELOW_D
                    for d in VARIANT_EDGE_D for _ in range(8)]
            require(oneid == want, f"{kid}: the one-id cases' tile")
            before = kernels.launches[kid]
            n = 0
            for call in calls:
                got_all = groups_pooled([a for _, a in call])
                for (key, a), got in zip(call, got_all):
                    want = group_pooled_plain(*a)
                    torch.cuda.synchronize()
                    same = (got == want) | (got.isnan() & want.isnan())
                    require(got.shape == want.shape and bool(same.all()),
                            f"{kid} edge case (d, L, weighted) = {key}: "
                            "kernel != plain")
                n += -(-len(call) // 8)
            require(kernels.launches[kid] - before == n,
                    f"{kid} edge cases: one launch per 8 groups")
            log(f"{kid} edge cases (d in {VARIANT_EDGE_D} x L in "
                f"{VARIANT_EDGE_L}, unweighted and weighted, SUM / MEAN / "
                "SQRTN columns; C = 6, Bp = 100; and 8 one-id groups at "
                "each d, C = 45, Bp = 100, ids past caps and below 0, "
                + ("on the one-id tile" if all(oneid) else
                   f"on the one-id tile at d < {X1_ONEID_F32_BELOW_D}, the "
                   "bag tile above")
                + "; "
                + ("-0.0 / NaN / +-inf rows" if dtype == "f32" else
                   "-0.0 / NaN / +-inf / subnormal rows and rounding ties"
                   if dtype == "bf16" else
                   "rows scaled over 12 orders of magnitude, a zero row "
                   "(scale 0) and a row at -127")
                + f"): kernel == plain, "
                f"{sum(len(c) for c in calls)} groups in {n} launches, "
                "one-id and bag groups mixed in each call")


def _equal_bits(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _on_cpu(torch, x):
    """x with every tensor in it (through tuples and lists) copied to the
    host."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (tuple, list)):
        return type(x)(_on_cpu(torch, y) for y in x)
    return x


def backward_calls(torch, eng, arrays, bp: int, cotangent):
    """The backward kernels' records for ``eng``'s groups on one unpacked
    batch: K3a one launch for every one-hot group (the batch's ids, with
    missing ids and ids past each cap added), X1b one launch for every
    gather group (its second run into outputs filled with NaN), each with
    a random cotangent ``cotangent(bp, C, d)``, the terms' magnitudes, the
    library yardstick (``torch.zeros`` + ``index_add_`` of precomputed
    contributions) and the bound (cotangent, ids and the whole gradient,
    each once); and the one partition launch of the step's forward that
    lists their entries (Part: X1b's groups, and K3a's groups cut into
    several vocab tiles), a ``partition_record``, whose lists the K3a and
    X1b records are given, as the step gives them.  Returns {"K3a": [...],
    "X1b": [...], "Part": [...]}."""
    from recom_tpu_torch.ops.lookup_gather import (
        group_pooled_grad_plain,
        groups_pooled_grad,
        slot_contributions,
        x1b_partition_groups,
    )
    from recom_tpu_torch.ops.item_lists import partition
    from recom_tpu_torch.ops.lookup_onehot import (
        k3_listed,
        k3_member_info,
        onehot_lookup_grad_plain,
        onehot_lookups_grad,
    )

    dev = torch.device("cuda")
    recs = {"K3a": [], "X1b": [], "Part": []}
    x1b = []                # the gather groups: X1b's one launch
    k3a = []                # the one-hot groups: K3a's one launch
    for g, packed in zip(eng.compiled.groups, arrays["groups"]):
        c = eng._consts[g.gid]
        table = eng.device_params["stacked"][str(g.gid)]
        ids, weights = eng.group_ids(g, packed)
        cot = cotangent(bp, g.num_columns, g.dim)
        if g.pallas_vocab is not None:
            # the batch's ids, with missing ids and ids past each cap
            ids2 = ids[:, :, 0].clone()
            ids2[:, ::17] = -1
            ids2[:, 5::19] = c["caps"][:, None] + 3
            c_pad, v = table.shape[0], table.shape[1]
            clamped = torch.minimum(ids2, c["caps"][:, None])
            valid = clamped >= 0
            cols = torch.arange(g.num_columns, device=dev)[:, None] * v
            k3a.append(dict(
                gid=g.gid, args=(cot, ids2, c["caps"], c_pad, v),
                flat=(cols + clamped.long())[valid],
                src=cot.transpose(0, 1)[valid], n=table.numel() // g.dim,
                d=g.dim, nbytes=(cot.numel() + ids2.numel() + g.num_columns
                                 + table.numel()) * 4,
                listed=k3_listed(v, g.dim),
                info=k3_member_info(g.num_columns, v, g.dim),
                shape=f"group {g.gid}: g [{bp}, {g.num_columns}, {g.dim}] "
                f"-> [{c_pad}, {v}, {g.dim}]",
            ))
            continue
        r = table.shape[0]
        cols = (c["row_offsets"], c["codes"])
        tail = (c["weighted"], c["caps"])
        rows, contrib = slot_contributions(cot, ids, *cols, weights,
                                           *tail)
        nbytes = (r * g.dim + cot.numel() + ids.numel() + 4 * g.num_columns
                  + (0 if weights is None else weights.numel())) * 4
        x1b.append(dict(
            gid=g.gid, args=(cot, r, ids) + cols + (weights,) + tail,
            mag=(cot.abs(), r, ids) + cols + (
                None if weights is None else weights.abs(),) + tail,
            lib=lambda r=r, d=g.dim, i=rows, s=contrib: torch.zeros(
                (r, d), device=dev).index_add_(0, i, s),
            nbytes=nbytes, flops=2.0 * contrib.numel(),
            large=r * g.dim > (1 << 27),
            shape=f"group {g.gid}: g [{bp}, {g.num_columns}, {g.dim}], "
            f"ids {list(ids.shape)} -> [{r}, {g.dim}]",
        ))
    # the step's one launch of Part: K3a's listed groups and X1b's; the
    # lists it writes, by the ids they were made from, for the K3a and X1b
    # records (on CPU copies of their arguments the plain versions take
    # no lists)
    listed = [x for x in k3a if x["listed"]]
    part = ([dict(ids=x["args"][1], caps=x["args"][2], info=x["info"])
             for x in listed]
            + x1b_partition_groups([x["args"] for x in x1b]))
    recs["Part"].append(partition_record(
        torch, "Part of the step: K3a's listed groups "
        + "+".join(str(x["gid"]) for x in listed) + ", X1b's groups "
        + "+".join(str(x["gid"]) for x in x1b), part))
    made = dict(zip([id(x["args"][1]) for x in listed]
                    + [id(x["args"][2]) for x in x1b], partition(part)))
    # K3a: every one-hot group in one launch
    if k3a:
        entries = [x["args"] for x in k3a]
        recs["K3a"].append(dict(
            what="K3a groups " + "+".join(str(x["gid"]) for x in k3a),
            fn=lambda *e: onehot_lookups_grad(
                e, lists=[made.get(id(a[1])) for a in e]),
            plain=lambda *e: [onehot_lookup_grad_plain(*a) for a in e],
            args=tuple(entries),
            mag_args=tuple((a[0].abs(),) + a[1:] for a in entries),
            lib=lambda: [torch.zeros((x["n"], x["d"]), device=dev)
                         .index_add_(0, x["flat"], x["src"]) for x in k3a],
            bound=bound_ms(sum(x["nbytes"] for x in k3a),
                           float(sum(x["src"].numel() for x in k3a))),
            shape="; ".join(x["shape"] for x in k3a),
        ))
    # X1b: every gather group in one launch, the second run into
    # outputs filled with NaN
    entries = [x["args"] for x in x1b]
    x1b_lists = lambda e: [made.get(id(a[2])) for a in e]
    recs["X1b"].append(dict(
        what="X1b groups " + "+".join(str(x["gid"]) for x in x1b),
        fn=lambda *e: groups_pooled_grad(e, lists=x1b_lists(e)),
        plain=lambda *e: [group_pooled_grad_plain(*a) for a in e],
        args=tuple(entries), mag_args=tuple(x["mag"] for x in x1b),
        into=lambda e: groups_pooled_grad(e, out=[torch.full(
            (a[1], a[0].shape[2]), float("nan"), device=dev) for a in e],
            lists=x1b_lists(e)),
        lib=lambda: [x["lib"]() for x in x1b],
        bound=bound_ms(sum(x["nbytes"] for x in x1b),
                       sum(x["flops"] for x in x1b)),
        classes=[(name, xs) for name, xs in (
            ("small-vocab groups (dense tiles)",
             [x for x in x1b if not x["large"]]),
            ("large-vocab groups (sparse ranges)",
             [x for x in x1b if x["large"]])) if xs],
        shape="; ".join(x["shape"] for x in x1b),
    ))
    return recs


def partition_record(torch, what: str, groups) -> dict:
    """A record of the partition pass (Part) over ``groups`` (dicts of
    ``item_lists.partition`` on the card): its bound counts the values
    read once (ids and caps, or raw values and their boundary rows) and
    the slots, values and offsets written once."""
    from recom_tpu_torch.ops.item_lists import off_rows, segments

    nbytes = 0
    for g in groups:
        src = g["ids"] if "ids" in g else g["raw"]
        c, s = src.shape
        nbytes += 4 * (3 * c * s + c + off_rows(g["info"]) * segments(s))
        nbytes += 4 * (g["hi"].numel() + g["counts"].numel()) \
            if "hi" in g else 0
    shape = "; ".join(
        f"[{(g['ids'] if 'ids' in g else g['raw']).shape[0]}, "
        f"{(g['ids'] if 'ids' in g else g['raw']).shape[1]}] entries, "
        f"{int(g['info'][:, 1].sum())} items" for g in groups)
    return dict(what=what, groups=groups, bound=bound_ms(nbytes, 0.0),
                shape=shape)


def check_partition(torch, what: str, groups) -> None:
    """Part on the card over ``groups``: two runs give the same integers,
    equal to its plain version on CPU copies of the inputs and to the
    plain version on the card (``==``: slots, values and offsets)."""
    from recom_tpu_torch.ops.item_lists import partition, partition_plain
    from recom_tpu_torch.ops.item_lists import plain_values

    got = [partition(groups) for _ in range(2)]
    torch.cuda.synchronize()
    cpu = [{k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in g.items()} for g in groups]
    wants = partition(cpu)
    for k, g in enumerate(groups):
        card_plain = partition_plain(plain_values(g), g["info"])
        for a, b, w, p in zip(got[0][k], got[1][k], wants[k], card_plain):
            require(torch.equal(a, b), f"{what}: two runs differ")
            require(torch.equal(a.cpu(), w), f"{what}: kernel != plain "
                    "version on CPU copies")
            require(torch.equal(a, p), f"{what}: kernel != plain version "
                    "on the card")


def measure_partition(torch, recs) -> dict:
    """Part's records checked (``check_partition``) and timed, warm, cold
    L2 and plain; summed as ``measure_backward`` sums its kernels (no one
    PyTorch call computes the lists and offsets: library null)."""
    from recom_tpu_torch.ops.item_lists import member_info, partition
    from recom_tpu_torch.ops.item_lists import partition_plain, plain_values

    tot = dict(err=0.0, ms=0.0, cold_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               lib=None)
    for r in recs:
        check_partition(torch, r["what"], r["groups"])
        kern = lambda r=r: partition(r["groups"])
        ms = time_ms(torch, kern)
        cold = time_cold_ms(torch, kern)
        pms = time_ms(torch, lambda r=r: [partition_plain(
            plain_values(g), g["info"]) for g in r["groups"]],
            iters=5, warmup=1)
        bms, _ = r["bound"]
        for k, v in (("ms", ms), ("cold_ms", cold), ("plain_ms", pms),
                     ("bound_ms", bms)):
            tot[k] += v
        log(f"{r['what']} ({r['shape']}): kernel {ms:.4f} ms warm, "
            f"{cold:.4f} ms cold L2, plain {pms:.4f} ms, bound {bms:.4f} ms "
            "(bytes); == plain on CPU copies and on the card, twice")
    log(f"Part summed over {len(recs)} launch(es): kernel {tot['ms']:.4f} ms "
        f"warm, {tot['cold_ms']:.4f} ms cold, bound {tot['bound_ms']:.4f} ms")
    # the floor under a launch: one block of one entry and one item
    one = [dict(ids=torch.zeros((1, 1), dtype=torch.int32, device="cuda"),
                caps=torch.zeros(1, dtype=torch.int32, device="cuda"),
                info=member_info([1], [1], [1]))]
    tot["floor_ms"] = time_ms(torch, lambda: partition(one))
    log(f"Part of one block (one entry, one item): {tot['floor_ms']:.4f} ms "
        "warm, the launch and one block's phases")
    return dict(tot, bound_by="bytes")


def k3a_group_cases(torch, cotangent) -> None:
    """K3a over several groups in one launch against the plain versions
    (``check_backward``): every shape of ``K3A_EDGES`` in one launch (listed
    and unlisted groups mixed); the Criteo DLRM's one-hot vocabularies at
    d = 64 with a column whose 2048 entries all select one row (one item
    holds them all, every other item of the column none) and a column with
    no entry; and X1b with every slot of a member on one row (a dense tile
    and a sparse range that hold all the slots, the rest none), each
    group's partition == its plain version."""
    import numpy as np

    from recom_tpu_torch.ops.lookup_gather import (
        group_pooled_grad_plain,
        groups_pooled_grad,
        x1b_partition_groups,
    )
    from recom_tpu_torch.ops.lookup_onehot import (
        k3_listed,
        k3_member_info,
        onehot_lookup_grad_plain,
        onehot_lookups_grad,
    )

    dev = torch.device("cuda")
    fn = lambda *e: onehot_lookups_grad(e)
    plain = lambda *e: [onehot_lookup_grad_plain(*a) for a in e]
    mag = lambda e: tuple((a[0].abs(),) + a[1:] for a in e)
    edges = []
    for cc, v, bb, d in K3A_EDGES:
        t3, ids_np, caps_np = k1_edge_case(cc, v, d, 700, seed=d + cc,
                                           specials=False)
        edges.append((cotangent(700, cc, d),
                      torch.from_numpy(ids_np).to(dev),
                      torch.from_numpy(caps_np).to(dev), t3.shape[0],
                      t3.shape[1]))
    check_backward(torch, f"K3a, the {len(edges)} edge shapes in one launch",
                   fn, plain, tuple(edges), mag(edges))
    rng = np.random.default_rng(31)
    hot = []
    for c, v in ((7, 128), (1, 2304), (1, 1664), (1, 1024), (1, 256)):
        ids_np = rng.integers(0, v - 30, (c, 2048)).astype(np.int32)
        caps_np = np.full(c, v - 40, np.int32)
        if v == 2304:
            ids_np[0] = 1500                  # 2048 entries on one row
        if v == 1664:
            ids_np[0] = -1                    # no entry
        c_pad = -(-c // 8) * 8
        hot.append((cotangent(2048, c, 64), torch.from_numpy(ids_np).to(dev),
                    torch.from_numpy(caps_np).to(dev), c_pad, v))
    check_backward(torch, "K3a, the Criteo DLRM's one-hot vocabularies in "
                   "one launch, a column on one row and one with no entry",
                   fn, plain, tuple(hot), mag(hot))
    check_partition(torch, "Part of K3a's hot and empty columns", [
        dict(ids=a[1], caps=a[2], info=k3_member_info(a[1].shape[0], a[4],
                                                      64))
        for a in hot if k3_listed(a[4], 64)])
    for rows, d in ((20_000, 8), (1 << 20, 32)):
        ids = torch.full((1, 2048, 1), 12_345, dtype=torch.int32, device=dev)
        args = (cotangent(2048, 1, d), rows, ids, np.zeros(1, np.int32),
                np.zeros(1, np.int32), None, np.zeros(1, bool),
                np.asarray([rows - 1], np.int32))
        check_backward(
            torch, f"X1b, 2048 slots on one row of {rows}",
            lambda *e: groups_pooled_grad(e),
            lambda *e: [group_pooled_grad_plain(*a) for a in e], (args,),
            ((args[0].abs(),) + args[1:],),
            into=lambda e: groups_pooled_grad(e, out=[torch.full(
                (a[1], a[0].shape[2]), float("nan"), device=dev)
                for a in e]))
        check_partition(torch, f"Part of X1b's hot member of {rows} rows",
                        x1b_partition_groups([args]))
    log(f"K3a in one launch: the {len(edges)} edge shapes; the Criteo "
        "DLRM's vocabularies with a column on one row and one with no "
        "entry; X1b with 2048 slots on one row (a dense tile, a sparse "
        "range): == plain on CPU copies, repeatable bit for bit; their "
        "partitions == plain")


def check_backward(torch, what: str, fn, plain, args, mag_args,
                   into=None) -> float:
    """A backward kernel's wrapper ``fn`` on the card (one output, or a
    list): two runs give the same bits (the second into outputs filled
    with NaN where ``into`` runs it, so every element must be written);
    those bits equal the wrapper on CPU copies of ``args`` (its plain
    version, ``index_add_`` in slot order); and the plain version on the
    card (``index_add_`` with atomics, in no fixed order) is within 1e-5 of
    the sum of the terms' magnitudes (``plain(*mag_args)``).  Returns the
    largest absolute difference from the card's plain version."""
    as_list = lambda x: list(x) if isinstance(x, (list, tuple)) else [x]
    outs = as_list(fn(*args))
    again = as_list(into(args) if into else fn(*args))
    torch.cuda.synchronize()
    require(all(_equal_bits(torch, a, b) for a, b in zip(outs, again)),
            f"{what}: two runs differ" + (" (the second into NaN-filled "
                                          "outputs)" if into else ""))
    del again
    wants = as_list(fn(*_on_cpu(torch, args)))
    require(all(_equal_bits(torch, o.cpu(), w) for o, w in zip(outs, wants)),
            f"{what}: kernel != plain version on CPU copies")
    del wants
    # one output at a time against the card's plain version, each dropped
    # once used: the peak stays one output, its plain version and the error
    plains = as_list(plain(*args))
    errs = []
    for i in range(len(outs)):
        errs.append((outs[i] - plains[i]).abs_())
        outs[i] = plains[i] = None
    del outs, plains
    mags = as_list(plain(*mag_args))
    require(all(bool((e <= 1e-5 * m).all()) for e, m in zip(errs, mags)),
            f"{what}: kernel differs from the plain version on the card by "
            "more than 1e-5 of the terms' magnitudes")
    return max((float(e.max()) for e in errs if e.numel()), default=0.0)


def measure_backward(torch, recs):
    """Each backward kernel's records (``recs``: {kernel id: [record]})
    checked by ``check_backward``, then timed: warm, cold L2, plain and
    library; X1b also per class of member where a record has classes.
    Returns {kernel id: summed results}."""
    results = {}
    for kid, rs in recs.items():
        require(bool(rs), f"no main-path call of {kid}")
        if kid == "Part":
            results[kid] = measure_partition(torch, rs)
            continue
        tot = dict(err=0.0, ms=0.0, cold_ms=0.0, plain_ms=0.0,
                   bound_ms=0.0, lib=0.0)
        bound_by = {"bytes": 0.0, "operations": 0.0}
        for r in rs:
            err = check_backward(torch, r["what"], r["fn"], r["plain"],
                                 r["args"], r["mag_args"], r.get("into"))
            kern = lambda r=r: r["fn"](*r["args"])
            ms = time_ms(torch, kern)
            cold = time_cold_ms(torch, kern)
            pms = time_ms(torch, lambda r=r: r["plain"](*r["args"]),
                          iters=5, warmup=1)
            lms = time_ms(torch, r["lib"])
            bms, by = r["bound"]
            bound_by[by] += bms
            for k, v in (("ms", ms), ("cold_ms", cold), ("plain_ms", pms),
                         ("bound_ms", bms), ("lib", lms)):
                tot[k] += v
            tot["err"] = max(tot["err"], err)
            log(f"{r['what']} ({r['shape']}): kernel {ms:.4f} ms warm, "
                f"{cold:.4f} ms cold L2, plain {pms:.4f} ms, library "
                f"(torch.zeros + index_add_) {lms:.4f} ms, bound "
                f"{bms:.4f} ms ({by}); == plain on CPU copies, max abs "
                f"diff from the card's plain version {err:.3g}")
            classes = []
            for name, xs in r.get("classes", ()):
                args = [x["args"] for x in xs]
                c_ms = time_ms(torch, lambda a=args: r["fn"](*a))
                c_lib = time_ms(torch, lambda xs=xs: [x["lib"]()
                                                      for x in xs])
                c_bound, _ = bound_ms(sum(x["nbytes"] for x in xs),
                                      sum(x["flops"] for x in xs))
                classes.append(dict(name=name, ms=c_ms, bound_ms=c_bound,
                                    library_ms=c_lib))
                log(f"  {kid}, {name} alone (one launch): kernel "
                    f"{c_ms:.4f} ms warm, library {c_lib:.4f} ms, bound "
                    f"{c_bound:.4f} ms")
            if classes:
                tot["classes"] = classes
        log(f"{kid} summed over {len(rs)} launch(es): kernel "
            f"{tot['ms']:.4f} ms warm, {tot['cold_ms']:.4f} ms cold, "
            f"bound {tot['bound_ms']:.4f} ms (share of bound, warm: "
            f"{tot['bound_ms'] / tot['ms']:.0%})")
        results[kid] = dict(tot, bound_by=max(bound_by, key=bound_by.get))
    return results


def train_phases(torch, model, np_params, batch_small, batch_big, ref):
    """Phases 7-10: train model E (default config, dlrm_optimizer) and the
    880-column bucketize model (host_bucketize=False) on the card; hold
    the backward kernels K3a, K3b and X1b against their plain versions at
    the path's shapes and on edge inputs, and time them; hold each path's
    captured training step to the eager one (``train_program_gate``: model
    E at every batch bucket).  Returns the kernels' results, the launch
    counts of one counted (replayed) step of each path and the step
    readings."""
    import numpy as np

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.models import make_dlrm_model, make_random_batch
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.ops.lookup_gather import (
        group_pooled_grad,
        group_pooled_grad_plain,
        groups_pooled_grad,
    )
    from recom_tpu_torch.ops.lookup_onehot import (
        bucket_bounds,
        bucket_ids_plain,
        k3_listed,
        k3_member_info,
        onehot_bucketize_lookup_grad,
        onehot_bucketize_lookup_grad_plain,
        onehot_lookup_grad,
        onehot_lookup_grad_plain,
    )
    from recom_tpu_torch.oracle.reference import run_mlp
    from recom_tpu_torch.runtime.wire import unpack_blob
    from recom_tpu_torch.runtime.graphs import CudaCapture
    from recom_tpu_torch.train import Trainer, dlrm_optimizer
    from recom_tpu_torch.utils.params import init_model_params

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)

    def cotangent(bp, c, d):
        return torch.from_numpy(
            rng.standard_normal((bp, c, d), dtype=np.float32)).to(dev)

    # ---- phase 7: the trainers --------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    tr = Trainer(model, EngineConfig(), optimizer=dlrm_optimizer(),
                 params=np_params)
    torch.cuda.synchronize()
    require(tr.engine.device.type == "cuda"
            and isinstance(tr._capture, CudaCapture)
            and tr._capture is not tr.engine._capture,
            "Trainer defaults to CUDA, steps through captured programs in a "
            "pool of its own")
    log(f"Trainer(model E, EngineConfig(), dlrm_optimizer()): "
        f"{time.perf_counter() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    bz_model = make_dlrm_model(880, 0, 0, 0, 0, 32, [32], [1024, 1024, 128],
                               name="bucketize880", seed=0)
    # dlrm_optimizer()'s tower_lr 1e-3 overshoots on this random tower:
    # Adam's first step moves every weight of the 1024-wide layers by
    # 1e-3 the same way, and the loss jumps 20x (on the CPU too, with the
    # plain versions); at 1e-5 it falls step after step
    bz_params = init_model_params(bz_model)
    tr_bz, tr_bz_eager = (
        Trainer(bz_model, EngineConfig(host_bucketize=False),
                optimizer=dlrm_optimizer(table_lr=1e-3, tower_lr=1e-5),
                params=bz_params) for _ in range(2))
    tr_bz_eager._capture = None
    eng, eng_bz = tr.engine, tr_bz.engine

    # ---- phase 8: the backward kernels against their plain versions -------
    recs = {"K3a": [], "K3b": [], "X1b": [], "Part": []}
    with torch.no_grad():
        prep = eng.prepare(batch_big)
        bp = prep.batch_padded
        arrays = unpack_blob(eng.compiled, eng.to_device(prep)["blob"], bp,
                             prep.rowlens, prep.wsig)
        recs.update(backward_calls(torch, eng, arrays, bp, cotangent))
        # K3b: the 880-column group, its raw plane with the special values
        prep_bz = eng_bz.prepare(make_random_batch(bz_model, 2048, seed=4))
        arrays_bz = unpack_blob(eng_bz.compiled,
                                eng_bz.to_device(prep_bz)["blob"], 2048,
                                prep_bz.rowlens, prep_bz.wsig)
        for g, packed in zip(eng_bz.compiled.groups, arrays_bz["groups"]):
            c = eng_bz._consts[g.gid]
            require("bz_hi" in c and "raw_bz" in packed,
                    f"bucketize group {g.gid} should take K2")
            raw = packed["raw_bz"].clone()
            cc = raw.shape[0]
            cnt = c["bz_counts"][:cc, 0].long()
            raw[:, 0:5] = torch.tensor(
                [float("nan"), float("inf"), float("-inf"), -0.0, 0.0],
                device=dev)
            pick = (torch.arange(64, device=dev)[None, :] * 7) % cnt[:, None]
            raw[:, 5:69] = c["bz_hi"][:cc].gather(1, pick)
            cot = cotangent(2048, cc, g.dim)
            table = eng_bz.device_params["stacked"][str(g.gid)]
            a = (cot, raw, c["bz_lo"], c["bz_hi"], c["bz_counts"])
            ids = bucket_ids_plain(raw, c["bz_hi"], c["bz_counts"])
            flat = (torch.arange(cc, device=dev)[:, None] * table.shape[1]
                    + ids.long()).reshape(-1)
            src = cot.transpose(0, 1).reshape(-1, g.dim)
            nbytes = (cot.numel() + raw.numel() + cc + int(cnt.sum())
                      + table.numel()) * 4
            recs["K3b"].append(dict(
                what=f"K3b group {g.gid}", fn=onehot_bucketize_lookup_grad,
                plain=onehot_bucketize_lookup_grad_plain, args=a,
                mag_args=(cot.abs(),) + a[1:],
                lib=lambda n=table.numel() // g.dim, d=g.dim, f=flat,
                s=src: torch.zeros((n, d), device=dev).index_add_(0, f, s),
                bound=bound_ms(nbytes, float(src.numel())),
                shape=f"g [2048, {cc}, {g.dim}], raw [{cc}, 2048] with NaN, "
                f"+-inf, +-0.0 and 64 boundaries a column -> "
                f"{list(table.shape)}",
            ))

        # edge inputs: == plain on CPU copies, twice the same bits
        for cc, v, bb, d in K3A_EDGES:
            t3, ids_np, caps_np = k1_edge_case(cc, v, d, bb, seed=d,
                                               specials=False)
            a = (cotangent(bb, cc, d), torch.from_numpy(ids_np).to(dev),
                 torch.from_numpy(caps_np).to(dev), t3.shape[0], t3.shape[1])
            check_backward(torch, f"K3a edge C={cc} V_pad={t3.shape[1]} "
                           f"Bp={bb} d={d}", onehot_lookup_grad,
                           onehot_lookup_grad_plain, a, (a[0].abs(),) + a[1:])
        log(f"K3a edge cases ((C, V, Bp, d) in {K3A_EDGES}: C not a multiple "
            "of the columns an item takes; Bp past a stage and a pass; V_pad "
            "384 and 2304; an all-missing column, ids past caps and below "
            "-1): == plain on CPU copies, repeatable bit for bit")
        k3a_group_cases(torch, cotangent)
        for v_pad, d, bb in [(v, dd, 100) for v in (128, 256, 384)
                             for dd in (1, 3, 8, 32)] + [(128, 8, 700),
                                                         (384, 3, 700)]:
                bm, cn, t3, raw_np = k2_edge_case(45, v_pad, d, bb,
                                                  seed=v_pad + d)
                a = (cotangent(bb, 45, d), torch.from_numpy(raw_np).to(dev),
                     *(torch.from_numpy(x).to(dev) for x in bucket_bounds(
                         bm, cn, v_pad, t3.shape[0])))
                check_backward(torch, f"K3b edge V_pad={v_pad} d={d}",
                               onehot_bucketize_lookup_grad,
                               onehot_bucketize_lookup_grad_plain, a,
                               (a[0].abs(),) + a[1:])
                if k3_listed(v_pad, d):
                    check_partition(torch, f"Part of K3b edge V_pad={v_pad} "
                                    f"d={d}", [dict(
                                        raw=a[1], hi=a[3], counts=a[4],
                                        info=k3_member_info(45, v_pad, d))])
        log("K3b edge cases (K2's 12 edge planes at Bp 100, two at Bp 700, "
            "past a stage: counts 0 and V_pad - 1, repeated, -inf-only and "
            "merged boundaries; NaN, +-inf, +-0.0, subnormals, boundaries and "
            "the floats below them; V_pad 384 at d = 32 in 3 listed tiles, "
            "its partition == plain): == plain on CPU copies, repeatable "
            "bit for bit")
        n_edge = 0
        for d in X1_EDGE_D:
            for ll in X1_EDGE_L:
                for weighted in (False, True):
                    tb, ids_np, offs, caps_np, codes, w_np, wc = x1_edge_case(
                        d, ll, seed=10 * d + ll, specials=False)
                    w = torch.from_numpy(w_np).to(dev) if weighted else None
                    wc = wc if weighted else np.zeros(len(wc), bool)
                    ids_t = torch.from_numpy(ids_np).to(dev)
                    cot = cotangent(ids_np.shape[1], ids_np.shape[0], d)
                    a = (cot, tb.shape[0], ids_t, offs, codes, w, wc, caps_np)
                    check_backward(
                        torch, f"X1b edge d={d} L={ll} weighted={weighted}",
                        group_pooled_grad, group_pooled_grad_plain, a,
                        (cot.abs(), tb.shape[0], ids_t, offs, codes,
                         None if w is None else w.abs(), wc, caps_np))
                    n_edge += 1
        log(f"X1b edge cases ({n_edge} groups: d in {X1_EDGE_D} x L in "
            f"{X1_EDGE_L}, unweighted and weighted; SUM, MEAN and SQRTN, "
            "all-missing and zero-weight bags, ids at and past caps): == "
            "plain on CPU copies, repeatable bit for bit")
        # both member classes in one group, and a crowded sparse range;
        # the second run into NaN-filled outputs
        n_cls = 0
        for d, weighted, crowded in X1B_CLASS_CASES:
            gc_, r, ids_np, offs, caps_np, codes, w_np, wc = x1b_class_case(
                d, seed=d + 100 * crowded, weighted=weighted, crowded=crowded)
            ids_t = torch.from_numpy(ids_np).to(dev)
            w = None if w_np is None else torch.from_numpy(w_np).to(dev)
            cot = torch.from_numpy(gc_).to(dev)
            a = ((cot, r, ids_t, offs, codes, w, wc, caps_np),)
            check_backward(
                torch, f"X1b class case d={d} weighted={weighted} "
                f"crowded={crowded}", lambda *e: groups_pooled_grad(e),
                lambda *e: [group_pooled_grad_plain(*x) for x in e], a,
                ((cot.abs(), r, ids_t, offs, codes,
                  None if w is None else w.abs(), wc, caps_np),),
                into=lambda e: groups_pooled_grad(e, out=[torch.full(
                    (x[1], x[0].shape[2]), float("nan"), device=dev)
                    for x in e]))
            n_cls += 1
        log(f"X1b class cases ({n_cls}, (d, weighted, crowded) in "
            f"{X1B_CLASS_CASES}: small- and large-vocab members in one "
            "group, slots spanning every range, in one range, a hot row, a "
            "range crowded past a window): == plain on CPU copies, "
            "repeatable bit for bit, NaN-filled outputs fully written")

        results = measure_backward(torch, recs)
        del recs, arrays, arrays_bz
        torch.cuda.empty_cache()
    log(f"peak device memory (the trainers and phase 8's kernel checks): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()

    # ---- phase 9: training path 1, model E ---------------------------------
    # the first step (batch 512) against the oracle's logits on the same
    # batch and params (phase 3's forward)
    lab_small = rng.integers(0, 2, 512).astype(np.float32)
    x = run_mlp(np_params["tower"]["top"], ref["tower_input"],
                model.tower.activation, None)[:, 0].astype(np.float64)
    want = float(np.mean(lab_small * np.logaddexp(0.0, -x)
                         + (1 - lab_small) * np.logaddexp(0.0, x)))
    before = eng.predict(batch_small)["output"]
    loss0 = tr.step(batch_small, lab_small)
    require(abs(loss0 - want) <= 1e-4 * abs(want),
            f"first step's loss {loss0} != the oracle's BCE {want}")
    after = eng.predict(batch_small)["output"]
    require(not np.array_equal(before, after), "predict after a step "
            "serves the same outputs as before it")
    log(f"model E, step 1 (batch 512): loss {loss0:.6f}, the oracle's BCE "
        f"{want:.6f} (within rtol 1e-4); predict after the step differs")
    lab_big = rng.integers(0, 2, 2048).astype(np.float32)
    # K3a 1 (model E's one-hot group is one vocab tile: not listed); X1b
    # 1, after the one partition launch of its groups
    path_e = dict(exactly={"K1": 1, "X1": 1, "X2": 3, "K3a": 1, "X1b": 1,
                           "Part": 1})
    kernels.reset_launches()
    losses = [tr.step(batch_big, lab_big)]      # eager pass + capture
    torch.cuda.synchronize()
    counts_first = dict(kernels.launches)
    require_launches(counts_first, ("K1", "X1", "X2", "K3a", "X1b", "Part"),
                     "training, model E, a signature's first step", **path_e)
    # the main path of training: a step replaying its captured program
    kernels.reset_launches()
    losses.append(tr.step(batch_big, lab_big))
    torch.cuda.synchronize()
    counts_train = dict(kernels.launches)
    log(f"launches in one training step (model E, batch 2048): the "
        f"signature's first (eager pass + capture) "
        f"{ {k: n for k, n in counts_first.items() if n} }, a replayed one "
        f"{counts_train}")
    require_launches(counts_train, ("K1", "X1", "X2", "K3a", "X1b", "Part"),
                     "training, model E, a replayed step", **path_e)
    losses += [tr.step(batch_big, lab_big) for _ in range(3)]
    require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
            f"model E losses on one batch do not decrease: {losses}")
    log(f"model E, 5 steps on one batch of 2048: losses {losses}")
    log(f"peak device memory (model E training): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del tr, eng
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 9b: model E's captured step == the eager step, every bucket -
    torch.cuda.reset_peak_memory_stats()
    pair_e = tuple(Trainer(model, EngineConfig(), optimizer=dlrm_optimizer(),
                           params=np_params) for _ in range(2))
    pair_e[1]._capture = None
    buckets = tuple(pair_e[0].engine.config.batch_buckets)
    require(len(buckets) == 7 and buckets[-1] == 2048,
            f"model E's batch buckets {buckets}")
    gate_e = train_program_gate(
        torch, *pair_e, [(bs, shuffled(batch_big, bs, seed=300 + bs))
                         for bs in buckets],
        "model E, dlrm_optimizer", ("K3a", "X1b", "Part"))
    times_e = step_times(torch, pair_e, "model E",
                         ((512, batch_small, lab_small),
                          (2048, batch_big, lab_big)))
    log(f"peak device memory (model E, a captured and an eager trainer): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del pair_e
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 9c: model E under host_bucketize=False, trained ------------
    # K1 searches the one-hot group's 880 bucketize members in its id read
    # and writes the [C, Bp] ids that K3a reads
    torch.cuda.reset_peak_memory_stats()
    tr_ref = Trainer(model, EngineConfig(), optimizer=dlrm_optimizer(),
                     params=np_params)
    pair_s = tuple(Trainer(model, EngineConfig(host_bucketize=False),
                           optimizer=dlrm_optimizer(), params=np_params)
                   for _ in range(2))
    pair_s[1]._capture = None
    from recom_tpu_torch.utils.tree import tree_leaves

    loss_r, grads_r = tr_ref.value_and_grad(batch_small, lab_small)
    loss_s, grads_s = pair_s[1].value_and_grad(batch_small, lab_small)
    same = [torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(tree_leaves(grads_s), tree_leaves(grads_r))]
    require(np.float64(loss_s).tobytes() == np.float64(loss_r).tobytes()
            and all(same), f"model E, host_bucketize=False: loss or "
            f"gradients != the default config's ({sum(same)} of "
            f"{len(same)} leaves equal)")
    log(f"model E, host_bucketize=False: loss and all {len(same)} gradient "
        "leaves == the default config's as bits (K3a on the ids K1 wrote "
        "== K3a on the host's ids)")
    del tr_ref, grads_r, grads_s
    gc.collect()
    torch.cuda.empty_cache()
    gate_s = train_program_gate(
        torch, *pair_s, [(512, batch_small), (2048, batch_big)],
        "model E, host_bucketize=False", ("K1", "K3a", "X1b", "Part"))
    for counts in gate_s["counts"]:
        require_launches(counts, ("K1", "X1", "X2", "K3a", "X1b", "Part"),
                         "training, model E, host_bucketize=False",
                         exactly={"K1": 1, "X1": 1, "K3a": 1, "X1b": 1,
                                  "Part": 1})
    log(f"launches in a training step (model E, host_bucketize=False, "
        f"2048): {gate_s['counts'][-1]}")
    del pair_s
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 10: training path 2, 880 bucketize columns (K2, K3b) --------
    b2 = make_random_batch(bz_model, 2048, seed=5)
    lab2 = rng.integers(0, 2, 2048).astype(np.float32)
    gate_bz = train_program_gate(torch, tr_bz, tr_bz_eager, [(2048, b2)],
                                 "bucketize-880, host_bucketize=False",
                                 ("K3b",))
    for counts_bz in gate_bz["counts"]:
        # one vocab tile of 4 columns at d = 8: K3b takes its columns'
        # batch rows whole, with no partition launch
        require_launches(counts_bz, ("K2", "K3b"), "training, bucketize-880",
                         exactly={"K2": 1, "K3b": 1, "Part": 0})
    losses = gate_bz["losses"]
    log(f"launches in each of 3 training steps (bucketize-880, batch "
        f"2048; a capture and two replays): {counts_bz}")
    require(bool(np.isfinite(losses).all())
            and all(b < a for a, b in zip(losses, losses[1:])),
            f"bucketize-880 losses on one batch do not decrease: {losses}")
    log(f"bucketize-880, 3 steps on one batch of 2048 (its rows in three "
        f"orders): losses {losses}")
    times_bz = step_times(torch, (tr_bz, tr_bz_eager), "bucketize-880",
                          ((2048, b2, lab2),))
    return dict(results=results, counts_train=counts_train,
                counts_bz=counts_bz, gate_e=gate_e, times_e=times_e,
                gate_bz=gate_bz, times_bz=times_bz, gate_searched=gate_s)


def _with_pooled(tr, batch, labels):
    """``tr.loss`` (``Trainer.loss``) on one batch, keeping each group's
    pooled output (the output of its K1 or X1 launch) and the grouped
    concat of the groups' post-lookup outputs with ``retain_grad``:
    (loss, [pooled [Bp, C, d] per group], [grouped [Bp, W]]).  The
    Engine's ``_embedding_forward`` is wrapped on the instance for this
    call only."""
    eng = tr.engine
    kept, concat = [], []
    inner = eng._embedding_forward

    def keep(arrays, *args):
        grouped, pooled, overflow = inner(arrays, *args)
        for p in pooled:
            p.retain_grad()
        if grouped.requires_grad:
            grouped.retain_grad()
        kept[:] = pooled
        concat[:] = [grouped]
        return grouped, pooled, overflow

    eng._embedding_forward = keep
    try:
        loss = tr.loss(eng.prepare(batch), labels)
    finally:
        del eng._embedding_forward
    return loss, kept, concat


def step_grads(torch, tr, batch, labels):
    """One step's backward without the update: (loss, {name: gradient of
    each param}, [cotangent of each group's pooled output], the grouped
    concat's cotangent [Bp, W])."""
    from recom_tpu_torch.train import param_leaves

    tr.optimizer.zero_grad(set_to_none=True)
    loss, pooled, concat = _with_pooled(tr, batch, labels)
    loss.backward()
    names = {id(t): f"table {k}" for k, t in tr.params["stacked"].items()}
    for k, layers in tr.params["tower"].items():
        for i, layer in enumerate(layers):
            for wb in ("w", "b"):
                names[id(layer[wb])] = f"tower {k}[{i}].{wb}"
    grads = {names[id(p)]: (p.grad if p.grad is not None
                            else torch.zeros_like(p)).detach()
             for p in param_leaves(tr.params)}
    cots = [p.grad.detach() for p in pooled]
    concat = concat[0].grad
    tr.optimizer.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, cots, concat


def grads_close(torch, card, cpu, batch, labels, what: str) -> tuple:
    """One training step's backward on the card (Trainer ``card``) against
    the same step on CPU copies (Trainer ``cpu``), in three parts:

    * each group's pooled-output cotangent (the tower and the post-lookup
      ops' backward, torch ops that sum in other orders on the card) within
      1e-5 of each element's magnitude plus its column's largest over the
      batch (no example is hot: they share one tower), or, where larger,
      the largest cotangent of the column's slot in the concat, which its
      post ops' backward takes apart (softmax then reduce_sum sums to 1
      whatever the input: the exact cotangent is 0, and each device's is
      the rounding of the slot's);
    * each table's gradient, the backward kernels' work, equal to the bit
      to the CPU's backward of its pooled outputs with the card's
      cotangents: every row, small or hot, exact;
    * the tower's gradients within 1e-5 of each element's magnitude plus
      the tensor's largest.

    Returns (the card's loss, the CPU's, the largest absolute difference
    of a cotangent or a tower gradient from the CPU's)."""
    loss, grads, cots, _ = step_grads(torch, card, batch, labels)
    want, wgrads, wcots, wcat = step_grads(torch, cpu, batch, labels)
    require(abs(loss - want) <= 1e-5 * abs(want),
            f"{what}: loss {loss} != the CPU's {want}")
    err = 0.0

    def close(name, a, b, scale):
        nonlocal err
        require(bool(torch.isfinite(a).all()), f"{what}: {name} not finite")
        diff = (a - b).abs()
        require(bool((diff <= 1e-5 * (b.abs() + scale)).all()),
                f"{what}: {name} differs from the CPU's by "
                f"{float(diff.max()):.3g}")
        err = max(err, float(diff.max()) if diff.numel() else 0.0)

    start = 0
    for gi, (g, a, b) in enumerate(zip(card.engine.compiled.groups, cots,
                                       wcots)):
        scale = b.abs().amax(dim=(0, 2), keepdim=True)
        for j, m in enumerate(g.members):
            if m.out_width and m.column.post:
                slot = wcat[:, start:start + m.out_width].abs().max()
                scale[0, j, 0] = torch.maximum(scale[0, j, 0], slot)
            start += m.out_width
        close(f"pooled cotangent of group {gi}", a.cpu(), b, scale)
    require(start == wcat.shape[1], f"{what}: concat width {start} != "
            f"{wcat.shape[1]}")
    # the CPU's table gradients from the card's cotangents
    _, pooled, _ = _with_pooled(cpu, batch, labels)
    tables = list(cpu.params["stacked"].values())
    again = torch.autograd.grad(pooled, tables, [c.cpu() for c in cots],
                                allow_unused=True)
    for k, t, g in zip(cpu.params["stacked"], tables, again):
        a = grads[f"table {k}"].cpu()
        g = torch.zeros_like(t) if g is None else g
        require(bool(torch.isfinite(a).all()), f"{what}: table {k} not "
                "finite")
        require(_equal_bits(torch, a, g), f"{what}: table {k}'s gradient "
                "!= the CPU's backward of the card's cotangents")
    for name, b in wgrads.items():
        if name.startswith("tower"):
            close(name, grads[name].cpu(), b,
                  b.abs().max() if b.numel() else 0.0)
    return loss, want, err


def postpool_phases(torch) -> None:
    """Phase 11: the PostPool models (models/postpool.py) served on the
    card and held to the oracle at the reference's tolerances (pooled
    outputs ==, concat at rtol 1e-6 / atol 1e-6, output at rtol 1e-5 /
    atol 1e-6, tests/test_postlookup.py's), each forward and training step
    launching exactly the kernels its lowering implies; then one training
    step's loss and gradients against the same step on CPU copies."""
    import numpy as np

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.models import (
        make_every_post_model,
        make_matmul_model,
        make_post_model,
        make_random_batch,
        make_softmax_mul_model,
    )
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.oracle import OracleModel
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.train import Trainer, dlrm_optimizer
    from recom_tpu_torch.utils.params import init_model_params

    rng = np.random.default_rng(11)
    cfg = EngineConfig(batch_buckets=(64,))
    for make, bs in ((make_post_model, 33), (make_softmax_mul_model, 29),
                     (make_matmul_model, 21), (make_every_post_model, 40)):
        model = make()
        params = init_model_params(model)
        batch = make_random_batch(model, bs, seed=bs)
        eng = Engine(model, cfg, params=params, device="cuda")
        fwd = fuzz_launches(eng.compiled, cfg, eng.prepare(batch))
        kernels.reset_launches()
        out = eng.predict(batch, return_pooled=True, return_concat=True)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        require_launches(counts, [k for k, n in fwd.items() if n],
                         f"PostPool {model.name}", exactly=fwd)
        counts = {k: n for k, n in counts.items() if n}
        ref = OracleModel(model, params).forward(batch)
        require(set(out["pooled"]) == set(ref["pooled"]),
                f"{model.name}: pooled columns")
        bad = [c for c, r in ref["pooled"].items()
               if not np.array_equal(out["pooled"][c], r)]
        require(not bad, f"{model.name}: pooled outputs differ from the "
                f"oracle: {bad}")
        require(out["concat"].shape == ref["concat"].shape,
                f"{model.name}: concat shape")
        np.testing.assert_allclose(out["concat"], ref["concat"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(out["output"], ref["output"], rtol=1e-5,
                                   atol=1e-6)
        hidden = [c.name for c in model.embedding_columns if not c.in_concat]
        log(f"PostPool model {model.name!r} (batch {bs}, hidden {hidden}): "
            f"launches {counts}; pooled outputs of all "
            f"{len(ref['pooled'])} columns == oracle, concat "
            f"{out['concat'].shape} within rtol 1e-6 / atol 1e-6, output "
            "within rtol 1e-5 / atol 1e-6 (max abs diff "
            f"{float(np.abs(out['output'] - ref['output']).max()):.3g})")
        labels = rng.integers(0, 2, bs).astype(np.float32)
        card = Trainer(model, cfg, optimizer=dlrm_optimizer(), params=params)
        cpu = Trainer(model, cfg, optimizer=dlrm_optimizer(), params=params,
                      device="cpu")
        loss, want, err = grads_close(torch, card, cpu, batch, labels,
                                      model.name)
        train = fuzz_launches(card.engine.compiled, cfg,
                              card.engine.prepare(batch), True)
        kernels.reset_launches()
        step = card.step(batch, labels)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        require_launches(counts, [k for k, n in train.items() if n],
                         f"training, PostPool {model.name}", exactly=train)
        counts = {k: n for k, n in counts.items() if n}
        require(np.isfinite(step) and all(
            bool(torch.isfinite(p).all()) for g in card.optimizer.param_groups
            for p in g["params"]), f"{model.name}: step not finite")
        log(f"  training step: loss {loss:.6f} (CPU {want:.6f}); gradients "
            "finite; pooled cotangents and tower gradients within 1e-5 of "
            f"the CPU's (max abs diff {err:.3g}); table gradients == the "
            f"CPU's backward of the card's cotangents; launches {counts}")
        del eng, card, cpu


def criteo_batch(model, bs: int, seed: int):
    """A Criteo-format batch as ``models/criteo.read_criteo_tsv`` gives it:
    each cat column's id a uniform 32-bit token (the TSV's hex ids), so
    that HashBucket spreads it over the whole vocab (a 1M-row column sees
    about ``bs`` distinct rows); each int column log(1 + x) of an integer
    in [0, 100)."""
    import numpy as np

    from recom_tpu_torch.ir.spec import FeatureKind
    from recom_tpu_torch.models import make_random_batch

    batch = make_random_batch(model, bs, seed=seed)
    rng = np.random.default_rng(seed)
    for col in model.columns:
        f = col.source.field
        if col.source.kind == FeatureKind.DENSE_INT:
            batch[f] = rng.integers(0, 2**32, bs, dtype=np.int64)
        else:
            batch[f] = np.log1p(batch[f]).astype(np.float32)
    return batch


def x1b_member_classes(torch, rec) -> list:
    """X1b at one gather group's shapes (``rec``: the group's X1b record
    from ``backward_calls``) timed with only some of its members' ids, the
    other members' slots missing (-1): none (each row of the dense
    gradient written as a zero), the members of dense tiles, and the
    members of sparse ranges (``x1b_sparse``).  One launch each; the
    dense output is the same size in all three."""
    from recom_tpu_torch.ops.lookup_gather import (
        groups_pooled_grad,
        x1b_sparse,
    )

    (entry,) = rec["args"]
    cot, r, ids, offs, codes, w, wt, caps = entry
    slots = ids.shape[1] * ids.shape[2]
    big = torch.tensor([x1b_sparse(int(c) + 1, cot.shape[2], slots)
                        for c in caps.tolist()], device=ids.device)
    out = []
    for name, keep in (("no ids (the zero stream alone)", big & ~big),
                       (f"{int((~big).sum())} members of dense tiles",
                        ~big),
                       (f"{int(big.sum())} members of sparse ranges", big)):
        ids_k = torch.where(keep[:, None, None], ids, torch.full_like(ids, -1))
        ms = time_ms(torch, lambda e=(cot, r, ids_k, offs, codes, w, wt, caps):
                     groups_pooled_grad([e]))
        out.append(dict(name=name, ms=ms))
        log(f"  X1b at Criteo, {name} alone: kernel {ms:.4f} ms warm")
    return out


def criteo_phases(torch):
    """Phases 12-14: the Criteo DLRM (models/criteo.py at full width: 26
    columns at d = 64, 1.90 GB of tables, bottom [512, 256, 64], top [512,
    256, 1]) served at batch 512 and 2048 and held to the oracle, its
    kernels (K1, X1; K3a, X1b) against their plain versions and timed at
    batch 2048, and trained.  Returns the kernels' results and launches."""
    import numpy as np

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.models import make_criteo_dlrm
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.oracle import OracleModel
    from recom_tpu_torch.oracle.reference import run_mlp
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.runtime.wire import unpack_blob
    from recom_tpu_torch.train import Trainer, dlrm_optimizer
    from recom_tpu_torch.utils.params import init_model_params

    rng = np.random.default_rng(13)

    def cotangent(bp, c, d):
        return torch.from_numpy(
            rng.standard_normal((bp, c, d), dtype=np.float32)).to("cuda")

    # ---- phase 12: serving ---------------------------------------------
    t = time.perf_counter()
    model = make_criteo_dlrm(seed=0)
    params = init_model_params(model)
    table_bytes = sum(a.nbytes for a in params["tables"].values())
    log(f"Criteo DLRM params on host: {time.perf_counter() - t:.1f} s, "
        f"{table_bytes / 1e9:.3f} GB of tables")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eng = Engine(model, EngineConfig(), params=params, device="cuda")
    torch.cuda.synchronize()
    groups = eng.compiled.groups
    n_onehot = sum(g.pallas_vocab is not None for g in groups)
    log(f"Engine(Criteo DLRM, EngineConfig()): {time.perf_counter() - t:.1f} "
        "s, groups " + "; ".join(
            f"gid {g.gid}: {g.num_columns} cols d={g.dim} "
            f"V_pad={g.pallas_vocab} rows={g.stacked_rows}" for g in groups))
    require(len(groups) - n_onehot == 1 and all(g.dim == 64 for g in groups)
            and table_bytes > 1.8e9, "Criteo: one gather group, d = 64")
    batches = {512: criteo_batch(model, 512, seed=2),
               2048: criteo_batch(model, 2048, seed=1)}
    oracle = OracleModel(model, params)
    refs = {}
    for bs, batch in batches.items():
        kernels.reset_launches()
        out = eng.predict(batch, return_pooled=True)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        log(f"launches in predict(Criteo, batch {bs}): {counts}")
        require_launches(counts, ("K1", "X1"), f"Criteo, batch {bs}",
                         exactly={"K1": 1, "X1": 1})
        t = time.perf_counter()
        refs[bs] = ref = oracle.forward(batch)
        require(len(ref["pooled"]) == 26, "26 pooled columns")
        bad = [c for c, r in ref["pooled"].items()
               if not np.array_equal(out["pooled"][c], r)]
        require(not bad, f"Criteo pooled outputs differ from the oracle: "
                f"{bad[:5]}")
        np.testing.assert_allclose(out["output"], ref["output"], rtol=1e-4,
                                   atol=1e-5)
        log(f"Criteo batch {bs}: pooled outputs of all 26 columns == oracle "
            f"(oracle {time.perf_counter() - t:.1f} s); output within rtol "
            "1e-4 / atol 1e-5 (max abs diff "
            f"{float(np.abs(out['output'] - ref['output']).max()):.3g})")
    serve_counts = counts
    latency(torch, eng, "Criteo DLRM", tuple(batches.items()))
    log(f"peak device memory (Criteo serving): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- phase 13: K1 and X1 at Criteo's shapes, batch 2048 ----------------
    prep = eng.prepare(batches[2048])
    bp = prep.batch_padded
    with torch.inference_mode():
        arrays = unpack_blob(eng.compiled, eng.to_device(prep)["blob"], bp,
                             prep.rowlens, prep.wsig)
    calls = {"K1": [], "X1": []}
    members, onehot = [], []
    for g, packed in zip(groups, arrays["groups"]):
        ids, weights = eng.group_ids(g, packed)
        if g.pallas_vocab is not None:
            onehot.append((g, ids))
        else:
            members.append(x1_member(torch, eng, g, ids, weights, bp))
    # K1 one launch for the five one-hot groups, X1 one for the rest
    calls["K1"].append(k1_call(torch, eng, onehot, bp))
    calls["X1"].append(x1_call(members))
    results = measure_forward(torch, calls)
    results["X1"]["oneid_f32_ab"] = x1_oneid_f32_ab(
        torch, calls["X1"][0], "the Criteo DLRM")
    del calls, members, arrays, eng
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 14: training ----------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    # dlrm_optimizer()'s tower rate 1e-3 overshoots on this random tower as
    # on model E's (ROADMAP Queue 3): the loss jumps on the second step of
    # a batch of 2048 (on the CPU too); at 1e-5 it falls step after step
    tr = Trainer(model, EngineConfig(),
                 optimizer=dlrm_optimizer(tower_lr=1e-5), params=params)
    with torch.no_grad():
        prep = tr.engine.prepare(batches[2048])
        arrays = unpack_blob(tr.engine.compiled,
                             tr.engine.to_device(prep)["blob"], bp,
                             prep.rowlens, prep.wsig)
        recs = backward_calls(torch, tr.engine, arrays, bp, cotangent)
        results.update(measure_backward(torch, recs))
        results["X1b"]["classes"] = x1b_member_classes(torch,
                                                       recs["X1b"][0])
        del recs, arrays
        torch.cuda.empty_cache()
    lab_small = rng.integers(0, 2, 512).astype(np.float32)
    x = run_mlp(params["tower"]["top"], refs[512]["tower_input"],
                model.tower.activation, None)[:, 0].astype(np.float64)
    want = float(np.mean(lab_small * np.logaddexp(0.0, -x)
                         + (1 - lab_small) * np.logaddexp(0.0, x)))
    loss0 = tr.step(batches[512], lab_small)
    require(abs(loss0 - want) <= 1e-4 * abs(want),
            f"Criteo first step's loss {loss0} != the oracle's BCE {want}")
    log(f"Criteo, step 1 (batch 512): loss {loss0:.6f}, the oracle's BCE "
        f"{want:.6f} (within rtol 1e-4)")
    lab_big = rng.integers(0, 2, 2048).astype(np.float32)
    kernels.reset_launches()
    losses = [tr.step(batches[2048], lab_big)]
    torch.cuda.synchronize()
    train_counts = dict(kernels.launches)
    log(f"launches in one training step (Criteo, batch 2048): "
        f"{train_counts}")
    # K1 once for the five one-hot groups; K3a once for all of them and
    # X1b once, after the forward's one partition launch (every one-hot
    # group at d = 64 but the smallest is cut into vocab tiles of 64 rows,
    # and X1b's group is listed too)
    require_launches(train_counts, ("K1", "X1", "K3a", "X1b", "Part"),
                     "training, Criteo", exactly={
                         "K1": 1, "X1": 1, "K3a": 1, "X1b": 1, "Part": 1})
    losses += [tr.step(batches[2048], lab_big) for _ in range(3)]
    require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
            f"Criteo losses on one batch do not decrease: {losses}")
    log(f"Criteo, 4 steps on one batch of 2048: losses {losses}")
    log(f"peak device memory (Criteo training and its kernel checks): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    pair = tuple(Trainer(model, EngineConfig(),
                         optimizer=dlrm_optimizer(tower_lr=1e-5),
                         params=params) for _ in range(2))
    pair[1]._capture = None
    gate = train_program_gate(torch, *pair, list(batches.items()),
                              "Criteo DLRM", ("K3a", "X1b", "Part"))
    times = step_times(torch, pair, "Criteo DLRM",
                       ((512, batches[512], lab_small),
                        (2048, batches[2048], lab_big)))
    del pair
    launches = {"K1": serve_counts["K1"], "X1": serve_counts["X1"],
                "K3a": train_counts["K3a"], "X1b": train_counts["X1b"],
                "Part": train_counts["Part"]}
    out = {k: dict(results[k], launches=launches[k]) for k in launches}
    out["training"] = {"gate": gate, "times": times}
    return out


def shuffled(batch, n: int, seed: int):
    """``n`` rows of ``batch`` in a random order of ``seed``: a distinct
    batch for milliseconds of host time (``make_random_batch`` takes
    seconds for 2048 rows of model E)."""
    import numpy as np

    rows = len(next(iter(batch.values())))
    idx = np.random.default_rng(seed).permutation(rows)[:n]
    out = {}
    for k, v in batch.items():
        require(isinstance(v, np.ndarray) and len(v) == rows,
                f"field {k} is not an array of one entry per example")
        out[k] = v[idx]
    return out


def pipeline_phase(torch, eng, base):
    """Model E through a ServingPipeline: 24 distinct batches (8 at 512, 12
    at 2048, 4 at 1500) from two submitting threads, each output == the
    same batch's sequential predict, launches exactly K1 24, X1 24, X2 72;
    a warmed dispatch under torch.cuda.set_sync_debug_mode("error"); each
    row's output the same bits at batch 100, 512 and 1500 as at 2048; the
    pipeline's throughput and latency against sequential predict at 2048,
    and throughput_under_sla.  Returns the counted launches."""
    import numpy as np

    from recom_tpu_torch import ServingPipeline
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.runtime.server import throughput_under_sla

    sizes = [512] * 8 + [2048] * 12 + [1500] * 4
    batches = [shuffled(base[i % len(base)], n, seed=100 + i)
               for i, n in enumerate(sizes)]
    want = [eng.predict(b)["output"] for b in batches]
    got = [None] * len(batches)
    kernels.reset_launches()
    with ServingPipeline(eng, prep_workers=4, max_inflight=4) as pipe:
        def submitter(k):
            futs = [(i, pipe.submit(batches[i]))
                    for i in range(k, len(batches), 2)]
            for i, f in futs:
                got[i] = f.result(timeout=300)

        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        require(not any(th.is_alive() for th in threads),
                "pipeline submitters did not finish")
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    log(f"launches in the pipeline's 24 requests: {counts}")
    require_launches(counts, ("K1", "X1", "X2"), "pipeline",
                     exactly={"K1": 24, "X1": 24, "X2": 72})
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if g is None or g.shape != w.shape or not np.array_equal(g, w)]
    require(not bad, f"pipeline outputs != sequential predict: requests "
            f"{bad}")
    require(pipe.stats["completed"] == 24, f"pipeline stats {pipe.stats}")
    log(f"pipeline (4 prep workers, max_inflight 4, two submitting "
        f"threads): 24 requests (8 x 512, 12 x 2048, 4 x 1500 padded to "
        f"2048) == sequential predict, in FIFO order; stats {pipe.stats}")

    # the tower's rows do not depend on the batch bucket
    full = eng.predict(base[0])["output"]
    for n in (100, 512, 1500):
        sub = {k: v[:n] for k, v in base[0].items()}
        require(np.array_equal(eng.predict(sub)["output"], full[:n]),
                f"rows at batch {n} != the same rows at batch 2048")
    log("model E: each row's output at batch 100, 512 and 1500 (buckets "
        "128, 512, 2048) == the same row's at batch 2048")

    # no host sync inside a warmed dispatch
    prep = eng.prepare(batches[10])
    eng.dispatch(prep).result()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rec = eng.dispatch(prep)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(np.array_equal(rec.result()["output"], want[10]),
            "dispatch under sync debug mode")
    log("Engine.dispatch (warmed, batch 2048) under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")

    # throughput and latency at 2048: sequential predict, then the pipeline
    big = [b for b, n in zip(batches, sizes) if n == 2048] * 2
    seq = []
    t0 = time.perf_counter()
    for b in big:
        t = time.perf_counter()
        eng.predict(b)
        seq.append((time.perf_counter() - t) * 1e3)
    seq_wall = time.perf_counter() - t0
    lat = []
    with ServingPipeline(eng, prep_workers=4, max_inflight=4) as pipe:
        t0 = time.perf_counter()
        futs = []
        for b in big:
            ts = time.perf_counter()
            f = pipe.submit(b)
            f.add_done_callback(lambda _, ts=ts: lat.append(
                (time.perf_counter() - ts) * 1e3))
            futs.append(f)
        for f in futs:
            f.result(timeout=300)
        wall = time.perf_counter() - t0
    rows = 2048 * len(big)
    seq_p50 = statistics.median(seq)
    log(f"batch 2048, {len(big)} requests: sequential predict "
        f"{rows / seq_wall:.0f} examples/s, p50 {seq_p50:.3f} ms, p99 "
        f"{float(np.percentile(seq, 99)):.3f} ms; ServingPipeline (4 prep "
        f"workers, max_inflight 4, all submitted at once) "
        f"{rows / wall:.0f} examples/s, p50 "
        f"{statistics.median(lat):.3f} ms, p99 "
        f"{float(np.percentile(lat, 99)):.3f} ms (host clock, submit to "
        "result, queueing included)")
    # a distinct batch for every timed request of the ladder, made before
    # it: the ladder's examples/s divides by a wall clock that holds the
    # factory's calls
    ladder, iters = (1, 2, 4, 8), 8
    pool = [shuffled(base[k % len(base)], 2048, seed=10_000 + k)
            for k in range(iters * sum(ladder))]
    rep = throughput_under_sla(
        eng, big[:3], sla_ms=4 * seq_p50, num_iterations=iters,
        worker_ladder=ladder, prep_workers=4, batch_factory=pool.__getitem__)
    del pool
    log(f"throughput_under_sla(batch 2048, sla_ms = 4 x sequential p50 = "
        f"{4 * seq_p50:.3f}, {iters} requests a worker, a distinct batch "
        f"each): {json.dumps(rep)}")
    return counts


def microbatch_phase(torch, eng, base) -> None:
    """64 requests of 1-64 rows through MicroBatcher(max_delay_ms=2.0) on
    the default bucket ladder: each request's rows == the request served
    alone (which pads to 32 or 64), in fewer flushes than requests."""
    import numpy as np

    from recom_tpu_torch import MicroBatcher

    sizes = np.random.default_rng(5).integers(1, 65, 64)
    reqs = [shuffled(base[i % len(base)], int(n), seed=2000 + i)
            for i, n in enumerate(sizes)]
    alone = [eng.predict(r)["output"] for r in reqs]
    t = time.perf_counter()
    with MicroBatcher(eng, max_delay_ms=2.0) as mb:
        futs = [mb.submit(r) for r in reqs]
        got = [f.result(timeout=300) for f in futs]
    dt = time.perf_counter() - t
    bad = [i for i, (g, w) in enumerate(zip(got, alone))
           if not np.array_equal(g, w)]
    require(not bad, f"MicroBatcher rows != the request served alone: "
            f"requests {bad}")
    require(mb.stats["flushes"] < 64, f"MicroBatcher stats {mb.stats}")
    log(f"MicroBatcher(max_delay_ms=2.0): 64 requests of 1-64 rows "
        f"({int(sizes.sum())} rows) in {mb.stats['flushes']} flushes, "
        f"{dt * 1e3:.1f} ms; each request's rows == the request served "
        "alone (bucket 32 or 64 alone, a larger one coalesced)")


def tower_cost(torch, eng, cases, name: str = "model E") -> None:
    """A model's device forward with the tower's products on fixed row
    chunks (executor.row_linear, the Engine's) against three other forms
    in their place: one strided-batched product over all of the batch's
    64-row tiles (the form before the chunks), ``matmul`` then ``+ b`` and
    ``addmm``; in turns, CUDA events, queued.  Then, with each other form,
    how many rows of a smaller batch differ from the same rows at 2048."""
    from recom_tpu_torch.runtime import executor

    chunked = executor.row_linear

    def tiles_64(x, w, b=None):
        m = x.shape[0]
        n = max(-(-m // 64), 2)
        xt = executor.pad_rows(x, n * 64).reshape(n, 64, x.shape[1])
        wt = w.expand(n, *w.shape)
        out = torch.bmm(xt, wt) if b is None else torch.baddbmm(b, xt, wt)
        return out.reshape(n * 64, w.shape[1])[:m]

    def matmul_b(x, w, b=None):
        y = torch.matmul(x, w)
        return y if b is None else y + b

    def addmm(x, w, b=None):
        return x @ w if b is None else torch.addmm(b, x, w)

    forms = {"row chunks": chunked, "64-row tiles": tiles_64,
             "matmul + b": matmul_b, "addmm": addmm}
    order = ["matmul + b", "addmm", "64-row tiles", "row chunks",
             "row chunks", "64-row tiles", "addmm", "matmul + b"]
    for bs, batch in cases:
        prep = eng.prepare(batch)
        on_dev = eng.to_device(prep)
        fwd = lambda: eng._forward(on_dev, prep.signature)
        res = {k: [] for k in forms}
        with torch.inference_mode():
            for form in order:
                executor.row_linear = forms[form]
                try:
                    res[form].append(time_ms(torch, fwd, iters=10))
                finally:
                    executor.row_linear = chunked
        mean = {k: statistics.mean(v) for k, v in res.items()}
        log(f"{name} device forward, batch {bs}: " + ", ".join(
            f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in res.items())
            + " (queued, 10 forwards each, in turns; row chunks / "
            + ", ".join(f"{k} {mean['row chunks'] / mean[k]:.3f}"
                        for k in forms if k != "row chunks") + ")")
    # what the row chunks are for: with each other form, how many rows of
    # a smaller batch differ from the same rows at 2048
    big = cases[-1][1]
    for form in ("64-row tiles", "matmul + b"):
        executor.row_linear = forms[form]
        try:
            full = eng.predict(big)["output"]
            differ = {n: int((eng.predict({k: v[:n] for k, v in big.items()})
                              ["output"] != full[:n]).any(axis=1).sum())
                      for n in (100, 512, 1500)}
        finally:
            executor.row_linear = chunked
        log(f"{name}: with the tower of {form}, rows of batch n differing "
            f"from the same rows at batch 2048: {differ} (with the row "
            "chunks: none)")


UPDATE_TABLES = ("emb_bucketize0", "emb_hash_str0", "emb_large_sparse0")


def update_rows(torch, eng, model, batch):
    """The updates of the update phases: every row of a bucketize column's
    table (a K1 plane), every row of a string hash table (stacked X1 rows),
    and 4096 rows of a 2^23 x 32 table (the ones ``batch`` reads first,
    then random ones), 512 of them given twice with a different last
    value.  Returns [(table, row ids, values)]."""
    import numpy as np

    from recom_tpu_torch.runtime.wire import unpack_blob

    rng = np.random.default_rng(50)
    out = []
    for t in UPDATE_TABLES[:2]:
        spec = model.tables[t]
        out.append((t, rng.permutation(spec.vocab_size),
                    rng.standard_normal((spec.vocab_size, spec.dim),
                                        dtype=np.float32)))
    t = UPDATE_TABLES[2]
    prep = eng.prepare(batch)
    with torch.inference_mode():
        arrays = unpack_blob(eng.compiled, eng.to_device(prep)["blob"],
                             prep.batch_padded, prep.rowlens, prep.wsig)
    (gi, mi), = [(gi, mi) for gi, g in enumerate(eng.compiled.groups)
                 for mi, m in enumerate(g.members) if m.table == t]
    ids, _ = eng.group_ids(eng.compiled.groups[gi], arrays["groups"][gi])
    col = ids[mi]
    read = col[col >= 0].unique().cpu().numpy()[:2048]
    extra = rng.integers(0, model.tables[t].vocab_size, 3584 - len(read))
    rows = np.concatenate([read, extra, read[:512]])
    rng.shuffle(rows[:-512])
    out.append((t, rows, rng.standard_normal((len(rows), 32),
                                             dtype=np.float32)))
    return out


def update_phase(torch, model, np_params, dtype, eng, batch, updates):
    """While a thread serves ``predict(batch, return_pooled=True)`` in a
    loop, the main thread calls update_table_rows for ``updates``: every
    served column == the pre-update predict's or a fresh engine's on the
    updated params (made on the host, last value wins).  Then the export
    of the updated rows == the stored dtype's rule (f32: the values; bf16:
    rounded to nearest even; int8: dequantize(quantize_rows_int8)), and a
    counted predict serves the new rows through the dtype's kernels.
    Returns that predict's launch counts."""
    import numpy as np

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.ops.quant import dequantize_table, quantize_rows_int8
    from recom_tpu_torch.runtime.checkpoint import export_params
    from recom_tpu_torch.runtime.executor import Engine

    tables = dict(np_params["tables"])
    for t, rows, vals in updates:
        tbl = tables[t].copy()
        for r, v in zip(rows, vals):      # in order: the last value wins
            tbl[r] = v
        tables[t] = tbl
    host_upd = {"tables": tables, "tower": np_params["tower"]}
    old = eng.predict(batch, return_pooled=True)["pooled"]
    t = time.perf_counter()
    fresh = Engine(model, EngineConfig(table_dtype=dtype), params=host_upd)
    new = fresh.predict(batch, return_pooled=True)["pooled"]
    log(f"{dtype}: fresh engine on the updated params: "
        f"{time.perf_counter() - t:.1f} s")
    del fresh
    free_engines()
    cols = {c for c, (gid, idx) in eng.compiled.column_slot.items()
            if eng.compiled.groups[gid].members[idx].table in UPDATE_TABLES}
    changed = {c for c in new if not np.array_equal(old[c], new[c])}
    require(changed == cols, f"{dtype}: the update changed columns "
            f"{sorted(changed)}, its tables feed {sorted(cols)}")

    state = {"n": 0, "torn": [], "mixed": 0}
    stop = threading.Event()

    def serve():
        try:
            while not stop.is_set():
                pooled = eng.predict(batch, return_pooled=True)["pooled"]
                seen = set()
                for c, x in pooled.items():
                    if np.array_equal(x, old[c]):
                        continue
                    if np.array_equal(x, new[c]):
                        seen.add(c)
                    else:
                        state["torn"].append(c)
                state["mixed"] += bool(seen) and seen != cols
                state["n"] += 1
        except Exception as e:     # surfaced by the main thread
            state["error"] = e

    th = threading.Thread(target=serve)
    th.start()
    while state["n"] < 1 and th.is_alive():
        time.sleep(0.005)
    t = time.perf_counter()
    for tname, rows, vals in updates:
        require(eng.update_table_rows(tname, rows, vals) == 1,
                f"{tname}: one member slot")
        time.sleep(0.1)
    t_upd = time.perf_counter() - t
    n_at = state["n"]
    while state["n"] < n_at + 2 and th.is_alive():
        time.sleep(0.005)
    stop.set()
    th.join(timeout=300)
    require(not th.is_alive() and "error" not in state,
            f"{dtype}: serving thread failed: {state.get('error')!r}")
    require(not state["torn"], f"{dtype}: torn columns under serving: "
            f"{sorted(set(state['torn']))[:5]}")
    log(f"{dtype}: {state['n']} predicts (batch 2048, pooled) served while "
        f"update_table_rows wrote {UPDATE_TABLES} ({t_upd:.3f} s with "
        f"100 ms pauses); every column == the old or the new table's "
        f"({state['mixed']} predicts saw some updated tables and not others)")

    exported = export_params(eng)
    for tname, rows, _ in updates:
        uniq = np.unique(rows)
        vals = host_upd["tables"][tname][uniq]
        if dtype == "bfloat16":
            vals = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
        elif dtype == "int8":
            vals = dequantize_table(*quantize_rows_int8(vals))
        require(np.array_equal(exported["tables"][tname][uniq], vals),
                f"{dtype}: export of {tname}'s updated rows != the rule")
    del exported
    kernels.reset_launches()
    final = eng.predict(batch, return_pooled=True)["pooled"]
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    want = {"float32": {"K1": 1, "X1": 1, "X2": 3},
            "bfloat16": {"K1-bf16": 1, "X1-bf16": 1, "X2": 3},
            "int8": {"X1-int8": 1, "X2": 3}}[dtype]
    require_launches(counts, tuple(want), f"model E {dtype} after updates",
                     exactly=want)
    bad = [c for c in new if not np.array_equal(final[c], new[c])]
    require(not bad, f"{dtype}: after the updates, columns {bad[:5]} != the "
            "fresh engine's")
    log(f"{dtype}: export of the updated rows == the rule; predict after "
        f"the updates == the fresh engine's on every column; launches "
        f"{counts}")
    return counts


def reload_phase(torch, model, np_params, served, eng):
    """reload_params of a second seed's params into the live engine:
    outputs == a fresh engine's on them, no new program, every tensor's
    data_ptr() unchanged.  Returns those params."""
    import numpy as np

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.models import make_model_e
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.train import param_leaves
    from recom_tpu_torch.utils.params import init_model_params

    small, big = served["batch_small"], served["batch_big"]
    t = time.perf_counter()
    p2 = init_model_params(make_model_e(seed=1))
    log(f"model E params of seed 1 on host: {time.perf_counter() - t:.1f} s")
    before = eng.predict(small, return_pooled=True)     # both signatures
    eng.predict(big)                                    # served already
    ptrs = [x.data_ptr() for x in param_leaves(eng.device_params)]
    compiles = eng.stats["compiles"]
    t = time.perf_counter()
    eng.reload_params(p2)
    torch.cuda.synchronize()
    t_reload = time.perf_counter() - t
    out_s = eng.predict(small, return_pooled=True)
    out_b = eng.predict(big)
    require(eng.stats["compiles"] == compiles, "reload_params compiled")
    require([x.data_ptr() for x in param_leaves(eng.device_params)] == ptrs,
            "reload_params moved a tensor")
    fresh = Engine(model, EngineConfig(), params=p2)
    want_s = fresh.predict(small, return_pooled=True)
    want_b = fresh.predict(big)
    del fresh
    require(np.array_equal(out_s["output"], want_s["output"])
            and np.array_equal(out_b["output"], want_b["output"])
            and all(np.array_equal(out_s["pooled"][c], p)
                    for c, p in want_s["pooled"].items()),
            "after reload_params, outputs != a fresh engine's on the params")
    require(not np.array_equal(before["output"], out_s["output"]),
            "reload_params changed no output")
    log(f"reload_params(seed 1's params) into the live engine: "
        f"{t_reload:.1f} s; outputs at 512 (pooled too) and 2048 == a fresh "
        f"engine's; compiles {compiles} unchanged; all {len(ptrs)} tensors "
        "in place")
    return p2


def reload_trainer_phase(torch, model, np_params, p2, served):
    """A Trainer steps, then ``trainer.engine.reload_params(p2)``: its
    tensors stay the same objects, and the next step's loss == a fresh
    Trainer's first loss on p2 at rtol 1e-6, launching K3a 1, X1b 1 and
    Part 1.  Returns that step's launch counts."""
    import numpy as np

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.train import Trainer, dlrm_optimizer, param_leaves

    small = served["batch_small"]
    labels = np.random.default_rng(9).integers(0, 2, 512).astype(np.float32)
    tr = Trainer(model, EngineConfig(), optimizer=dlrm_optimizer(),
                 params=np_params)
    tr.step(small, labels)
    leaves = param_leaves(tr.params)
    t = time.perf_counter()
    tr.engine.reload_params(p2)
    torch.cuda.synchronize()
    t_reload = time.perf_counter() - t
    require(all(a is b for a, b in zip(param_leaves(tr.params), leaves)),
            "reload_params replaced a Trainer tensor")
    kernels.reset_launches()
    loss = tr.step(small, labels)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require_launches(counts, ("K1", "X1", "X2", "K3a", "X1b", "Part"),
                     "Trainer step after reload_params",
                     exactly={"K1": 1, "X1": 1, "X2": 3, "K3a": 1, "X1b": 1,
                              "Part": 1})
    del tr, leaves
    free_engines()
    tr2 = Trainer(model, EngineConfig(), optimizer=dlrm_optimizer(),
                  params=p2)
    loss2 = tr2.step(small, labels)
    del tr2
    free_engines()
    require(np.isfinite(loss) and abs(loss - loss2) <= 1e-6 * abs(loss2),
            f"loss after reload_params {loss} != a fresh Trainer's {loss2}")
    log(f"Trainer(model E, dlrm_optimizer()): a step, reload_params(seed 1) "
        f"in {t_reload:.1f} s, the next step's loss {loss:.7f} == a fresh "
        f"Trainer's first {loss2:.7f} (rtol 1e-6); launches {counts}")
    return counts


def profiled_kernels(torch, fn) -> tuple:
    """(``fn()``, {kernel id: device kernels of csrc/ that
    ``torch.profiler`` saw run in the call}), named by
    ``kernels.kernel_of``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from recom_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    seen = {}
    for ev in prof.events():
        kid = (kernels.kernel_of(ev.name)
               if ev.device_type == DeviceType.CUDA else None)
        if kid is not None:
            seen[kid] = seen.get(kid, 0) + 1
    return out, seen


def profiled_ops(torch, fn) -> tuple:
    """(``fn()``, {device kernel name: runs}) of what ``torch.profiler``
    saw run on the card in the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            names[ev.name] = names.get(ev.name, 0) + 1
    return out, names


def served_outputs(rec) -> dict:
    """The numpy outputs of a dispatched record's true rows, waited on:
    ``output``, and ``concat`` and ``pooled_groups`` where dispatched."""
    out = rec.result()
    res = {"output": out["output"]}
    if "concat" in out:
        res["concat"] = out["concat"]
    if "pooled_groups" in rec.host:
        res["pooled_groups"] = [p.numpy() for p in rec.host["pooled_groups"]]
    return res


def eager_outputs(torch, eng, prepared, mode=()) -> dict:
    """``Engine._forward`` run eagerly on ``prepared`` (staged on the
    card), as ``served_outputs`` gives a dispatch's."""
    with torch.inference_mode():
        out = eng._forward(eng.to_device(prepared), prepared.signature, mode)
    b = prepared.batch_size
    res = {"output": out["output"][:b].cpu().numpy()}
    if "concat" in mode:
        res["concat"] = out["concat"][:b].cpu().numpy()
    if "pooled" in mode:
        res["pooled_groups"] = [p[:b].cpu().numpy()
                                for p in out["pooled_groups"]]
    return res


def same_bits(a: dict, b: dict) -> bool:
    """Every array of ``a`` and ``b`` equal as bits (keys alike)."""
    import numpy as np

    def flat(d):
        return [x for k in sorted(d) for x in (
            d[k] if isinstance(d[k], list) else [d[k]])]

    fa, fb = flat(a), flat(b)
    return sorted(a) == sorted(b) and len(fa) == len(fb) and all(
        x.shape == y.shape and x.dtype == y.dtype and np.array_equal(
            x.view(np.uint8), y.view(np.uint8)) for x, y in zip(fa, fb))


def graph_phases(torch, eng, np_params, served) -> dict:
    """Model E's programs, one captured CUDA graph per (signature, mode),
    on a fresh engine in the default config: the first request of a
    signature (its eager pass and capture) timed against a replayed one;
    a new signature (bucket 1024) arriving while a 2-worker
    ServingPipeline serves warmed requests at 2048 (each output == the
    eager forward's); ``warmup`` of the other five buckets from
    representative batches (timed; memory after); at every bucket the
    replay == ``Engine._forward`` run eagerly, as bits, on ``output``,
    ``concat`` and ``pooled``, on the capture's batch and on its rows
    permuted, each replay launching what the eager pass launched (at
    2048: K1 1, X1 1, X2 3); ``stats["compiles"]`` the number of programs, no more than the buckets for each mode; pooled ==
    the oracle through a replay; and ``update_table_rows`` after capture
    (a one-hot plane's table and a string hash table, every row) served
    by the next replay, then undone.  Returns the readings."""
    import numpy as np

    from recom_tpu_torch import ServingPipeline
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.runtime.graphs import Program

    t_phase = time.perf_counter()
    buckets = tuple(eng.config.batch_buckets)
    big = served["batch_big"]
    require(len(buckets) == 7 and buckets[-1] == 2048
            and eng.stats["compiles"] == 0, f"a fresh engine with 7 "
            f"buckets, got {buckets}, {eng.stats}")
    rep = {bs: big if bs == 2048 else shuffled(big, bs, seed=300 + bs)
           for bs in buckets}
    preps = {bs: eng.prepare(b) for bs, b in rep.items()}
    read = {}

    # ---- one signature: the first request (eager pass + capture), then
    # a replay
    torch.cuda.synchronize()
    t = time.perf_counter()
    first = served_outputs(eng.dispatch(preps[2048]))
    read["first_request_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    again = served_outputs(eng.dispatch(preps[2048]))
    read["replayed_request_ms"] = (time.perf_counter() - t) * 1e3
    require(eng.stats["compiles"] == 1 and same_bits(first, again),
            "model E at 2048: the replay != the first (eager) request")
    log(f"model E, batch 2048: first request (eager pass + capture, "
        f"dispatch to result) {read['first_request_ms']:.3f} ms; a replayed "
        f"one {read['replayed_request_ms']:.3f} ms (host clock)")

    # ---- a new signature while a 2-worker pipeline serves -----------------
    stream = [shuffled(big, 2048, seed=400 + k) for k in range(8)]
    stream.insert(4, rep[1024])
    want = [eager_outputs(torch, eng, eng.prepare(b))["output"]
            for b in stream]
    kernels.reset_launches()
    with ServingPipeline(eng, prep_workers=2, max_inflight=4) as pipe:
        futs = [pipe.submit(b) for b in stream]
        got = [f.result(timeout=300) for f in futs]
    torch.cuda.synchronize()
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not np.array_equal(g, w)]
    require(not bad, f"pipeline with a new signature: requests {bad} != "
            "the eager forward")
    require(eng.stats["compiles"] == 2 and len(eng._programs) == 2,
            f"the 1024 request made one program: {eng.stats}")
    require_launches(dict(kernels.launches), ("K1", "X1", "X2"),
                     "pipeline with a new signature",
                     exactly={"K1": 9, "X1": 9})
    log(f"ServingPipeline (2 prep workers): 8 warmed requests at 2048 and "
        f"a new signature (bucket 1024) among them == the eager forward; "
        f"one program captured in flight; launches "
        f"{ {k: n for k, n in kernels.launches.items() if n} }")

    # ---- the other buckets -------------------------------------------------
    torch.cuda.synchronize()
    t = time.perf_counter()
    n = eng.warmup(batches=[rep[bs] for bs in buckets[:5]])
    read["warmup_5_buckets_s"] = time.perf_counter() - t
    read["memory_allocated_gib"] = torch.cuda.memory_allocated() / 2**30
    read["memory_reserved_gib"] = torch.cuda.memory_reserved() / 2**30
    require(n == 5 and eng.stats["compiles"] == len(eng._programs) == 7
            and all(isinstance(p, Program) for p in eng._programs.values()),
            f"warmup of 5 more buckets: {n} new, {eng.stats}")
    log(f"warmup(5 buckets, 32-512, from representative batches): "
        f"{read['warmup_5_buckets_s']:.3f} s; 7 programs; device memory "
        f"allocated {read['memory_allocated_gib']:.3f} GiB, reserved "
        f"{read['memory_reserved_gib']:.3f} GiB")

    # ---- replay == eager at every bucket, with the same launches ---------
    mode = ("concat", "pooled")
    for bs in buckets:
        p = preps[bs]
        counts = []
        outs = []
        for m in (mode, mode, ()):            # capture, replay, replay
            kernels.reset_launches()
            outs.append(served_outputs(eng.dispatch(p, m)))
            counts.append(dict(kernels.launches))
        want = eager_outputs(torch, eng, p, mode)
        require(same_bits(outs[1], want) and same_bits(outs[0], want)
                and same_bits(outs[2], {"output": want["output"]}),
                f"bucket {bs}: the replay != the eager forward")
        # the same rows in another order: the signature's program replayed
        # on other values in each row's place (a replay that did not load
        # its inputs, or lacked a kernel whose output buffer still held the
        # capture's values, would serve the batch above)
        q = eng.prepare(shuffled(rep[bs], bs, seed=500 + bs))
        require(q.signature == p.signature,
                f"bucket {bs}: a permuted batch has another signature")
        moved = served_outputs(eng.dispatch(q, mode))
        require(same_bits(moved, eager_outputs(torch, eng, q, mode))
                and not np.array_equal(moved["output"], want["output"]),
                f"bucket {bs}: the replay on permuted rows != the eager "
                "forward, or == the batch before it")
        require(counts[0] == counts[1] == counts[2],
                f"bucket {bs}: launches eager {counts[0]}, replays "
                f"{counts[1]}, {counts[2]}")
        if bs == 2048:
            require_launches(counts[1], ("K1", "X1", "X2"),
                             "model E replay at 2048",
                             exactly={"K1": 1, "X1": 1, "X2": 3})
        read.setdefault("launches", {})[bs] = {
            k: c for k, c in counts[1].items() if c}
    per_mode = {}
    for _, m in eng._programs:
        per_mode[m] = per_mode.get(m, 0) + 1
    require(eng.stats["compiles"] == len(eng._programs) == 14
            and all(c <= len(buckets) for c in per_mode.values()),
            f"programs {per_mode}, {eng.stats}")
    log(f"model E at every bucket {buckets}: the replay == the eager "
        f"forward as bits (output, concat, pooled), on the capture's batch "
        f"and on its rows permuted, each launching what the "
        f"eager pass did {read['launches']}; programs {per_mode} "
        f"(stats['compiles'] {eng.stats['compiles']})")

    # ---- pooled == the oracle through a replay ---------------------------
    for _ in range(2):
        out = eng.predict(served["batch_small"], return_pooled=True)
    check_pooled(served["ref"], out, "model E, batch 512, replayed")

    # ---- updates after capture, served by the next replay ----------------
    p = preps[2048]
    before = served_outputs(eng.dispatch(p, mode))
    rng = np.random.default_rng(60)
    for tname in UPDATE_TABLES[:2]:
        vocab, dim = np_params["tables"][tname].shape
        eng.update_table_rows(tname, np.arange(vocab), rng.standard_normal(
            (vocab, dim), dtype=np.float32))
    after = served_outputs(eng.dispatch(p, mode))
    require(same_bits(after, eager_outputs(torch, eng, p, mode))
            and not np.array_equal(after["output"], before["output"]),
            "update_table_rows after capture: the replay != the eager "
            "forward, or did not change")
    for tname in UPDATE_TABLES[:2]:
        vocab = np_params["tables"][tname].shape[0]
        eng.update_table_rows(tname, np.arange(vocab),
                              np_params["tables"][tname])
    require(same_bits(served_outputs(eng.dispatch(p, mode)), before),
            "the tables written back: the replay != before the update")
    log(f"update_table_rows after capture ({', '.join(UPDATE_TABLES[:2])}, "
        "every row): the next replay == the eager forward on the new "
        "rows; written back, == before")
    read["phase_s"] = time.perf_counter() - t_phase
    log(f"graph phases: {read['phase_s']:.1f} s")
    return read


def runtime_phases(torch, model, np_params, served):
    """The serving runtime and the parameter lifecycle at model E's full
    width, one engine at a time: pipeline, MicroBatcher, the tower's row
    tiles against a plain addmm, updates under serving (f32, bf16, int8)
    and reloads.  Returns the launch counts of each counted run."""
    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.models import make_random_batch
    from recom_tpu_torch.runtime.executor import Engine

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    base = [served["batch_big"]] + [make_random_batch(model, 2048, seed=s)
                                    for s in (40, 41)]
    log(f"two more model E batches of 2048: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    eng = Engine(model, EngineConfig(), params=np_params)
    torch.cuda.synchronize()
    log(f"Engine(model E, EngineConfig()): {time.perf_counter() - t:.1f} s")
    print_json("graph phases (model E, NVIDIA card above)",
               graph_phases(torch, eng, np_params, served))
    counts = {"pipeline": pipeline_phase(torch, eng, base)}
    microbatch_phase(torch, eng, base)
    tower_cost(torch, eng, ((512, served["batch_small"]),
                            (2048, served["batch_big"])))
    big = served["batch_big"]
    updates = update_rows(torch, eng, model, big)
    counts["float32"] = update_phase(torch, model, np_params, "float32", eng,
                                     big, updates)
    p2 = reload_phase(torch, model, np_params, served, eng)
    del eng
    free_engines()
    for dtype in ("bfloat16", "int8"):
        t = time.perf_counter()
        eng = Engine(model, EngineConfig(table_dtype=dtype), params=np_params)
        log(f"Engine(model E, table_dtype={dtype!r}): "
            f"{time.perf_counter() - t:.1f} s")
        counts[dtype] = update_phase(torch, model, np_params, dtype, eng, big,
                                     updates)
        del eng
        free_engines()
    counts["trainer"] = reload_trainer_phase(torch, model, np_params, p2,
                                             served)
    del p2
    log(f"peak device memory (serving runtime and parameter lifecycle): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


# model F's tower: K = 9704 -> 2048 -> 1024 -> 1024 -> 512 -> 1
MODEL_F_TOWER = (9704, 2048, 1024, 1024, 512, 1)


def model_f_phase(torch):
    """Model F at full width (1200 columns: a 1090-column one-hot group,
    100 string-hash columns, 7 lists and three 2^23 x 32 tables, 3.04 GiB
    of f32 tables), served with EngineConfig() at 512 and 2048: launches
    exactly K1 1, X1 1, X2 3 a predict, every pooled column == the oracle
    and the output within rtol 1e-4 / atol 1e-5, each row's output at 100,
    512 and 1500 == the same row's at 2048; predict latency, the queued
    device forward and peak memory; K1 and X1 at its shapes at batch 2048
    against their plain versions, timed.  Returns the model, its params,
    its two batches, the kernels' results and launch counts."""
    import numpy as np

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.models import make_model_f, make_random_batch
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.oracle import OracleModel
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.utils.params import init_model_params

    t = time.perf_counter()
    model = make_model_f(seed=0)
    params = init_model_params(model)
    table_bytes = sum(a.nbytes for a in params["tables"].values())
    log(f"model F params on host: {time.perf_counter() - t:.1f} s, "
        f"{table_bytes / 2**30:.2f} GiB of tables")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eng = Engine(model, EngineConfig(), params=params)
    torch.cuda.synchronize()
    groups = eng.compiled.groups
    log(f"Engine(model F, EngineConfig()): {time.perf_counter() - t:.1f} s, "
        "groups " + "; ".join(
            f"gid {g.gid}: {g.num_columns} cols d={g.dim} "
            f"V_pad={g.pallas_vocab} rows={g.stacked_rows}" for g in groups))
    require([(g.num_columns, g.pallas_vocab is not None) for g in groups]
            == [(1090, True), (100, False), (7, False), (3, False)],
            "model F lowers to its four groups")
    t = time.perf_counter()
    batches = {512: make_random_batch(model, 512, seed=2),
               2048: make_random_batch(model, 2048, seed=1)}
    log(f"model F batches of 512 and 2048: {time.perf_counter() - t:.1f} s")
    oracle = OracleModel(model, params)
    counts = {}
    for bs, batch in batches.items():
        kernels.reset_launches()
        out = eng.predict(batch, return_pooled=True)
        torch.cuda.synchronize()
        counts[bs] = dict(kernels.launches)
        log(f"launches in predict(model F, batch {bs}): {counts[bs]}")
        require_launches(counts[bs], ("K1", "X1", "X2"),
                         f"model F, batch {bs}",
                         exactly={"K1": 1, "X1": 1, "X2": 3})
        t = time.perf_counter()
        ref = oracle.forward(batch)
        log(f"oracle forward (model F, batch {bs}): "
            f"{time.perf_counter() - t:.1f} s")
        check_pooled(ref, out, f"model F, batch {bs}", cols=1200)
    full = out["output"]
    for n in (100, 512, 1500):
        sub = {k: v[:n] for k, v in batches[2048].items()}
        require(np.array_equal(eng.predict(sub)["output"], full[:n]),
                f"model F: rows at batch {n} != the same rows at batch 2048")
    log("model F: each row's output at batch 100, 512 and 1500 (buckets "
        "128, 512, 2048) == the same row's at batch 2048")
    k = MODEL_F_TOWER
    flops = 2 * 2048 * sum(a * b for a, b in zip(k, k[1:]))
    log(f"model F tower at 2048 (computed): {flops / 1e9:.1f} GFLOP, at "
        f"least {flops / F32_FLOPS_PER_S * 1e3:.3f} ms at 67 TFLOP/s (f32, "
        "TF32 off)")
    latency(torch, eng, "model F", tuple(batches.items()))
    tower_cost(torch, eng, tuple(batches.items()), "model F")
    log(f"peak device memory (model F serving): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    recs = stored_records(torch, eng, batches[2048], "K1", "X1")
    results = measure_forward(torch, recs)
    results["X1"]["oneid_f32_ab"] = x1_oneid_f32_ab(torch, recs["X1"][0],
                                                    "model F")
    del eng
    free_engines()
    return dict(model=model, params=params, batches=batches,
                results=results, counts=counts[2048])


def fresh_batch(batch, n: int, seed: int):
    """``n`` rows of ``batch`` in an order of ``seed`` (``shuffled``), every
    string drawn anew from ``seed`` with the same lengths and delimiters:
    ids the base batch never had in every hashed column (so in the large
    tables' rows), for milliseconds of host time."""
    import numpy as np

    out = shuffled(batch, n, seed)
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789",
                            np.uint8)
    for k, v in out.items():
        if v.dtype.kind != "S":
            continue
        u = v.view(np.uint8).reshape(len(v), v.dtype.itemsize).copy()
        keep = (u == 0) | (u == ord(";"))
        u[~keep] = letters[rng.integers(0, len(letters), int((~keep).sum()))]
        out[k] = u.view(v.dtype).reshape(len(v))
    return out


def batch_maker(base):
    """A tools' batch factory over ``base`` (batches of 2048):
    ``make(model, bs, n, seed0)`` gives n distinct batches of ``bs`` rows,
    each ``fresh_batch`` of a base batch with a seed of its own."""
    def make(model, bs, n, seed0):
        return [fresh_batch(base[(seed0 + i) % len(base)], bs,
                            seed=seed0 + i) for i in range(n)]

    return make


def require_tool_launches(counts, kids, what: str) -> None:
    """A tool's run went through its path's kernels ``kids`` (each launched
    at least once) and no kernel off its path."""
    require_launches(counts, kids, what)
    log(f"{what}: launches {dict((k, n) for k, n in counts.items() if n)}")


def print_json(what: str, doc) -> None:
    log(f"{what}:")
    print(json.dumps(doc), flush=True)


def tools_phases(torch, model_e, params_e, base_e):
    """The measurement tools and entry points (recom_tpu_torch/tools/,
    entry.py) on the card: model F at full width (``model_f_phase``);
    ae_sweep on models E and F at batch 32, 512 and 2048, the naive arm at
    512 on model E, the workers sweep {2, 4} at 2048 on model E;
    benchmark on model F at 2048 with two workers under torch.profiler;
    bw_breakdown on model E at 2048; embedding_bw on model E (its pooled
    round == X1's plain version); ragged_bench's four rungs (X1 == its
    plain version at each); entry() == Engine.predict, and
    dryrun_multichip(1).  Each tool's JSON is printed.  Returns model F's
    and the ragged rungs' results."""
    import os
    import tempfile

    import numpy as np

    from recom_tpu_torch import EngineConfig, entry
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.tools import (
        ae_sweep,
        benchmark,
        bw_breakdown,
        embedding_bw,
        ragged_bench,
    )

    make_e = batch_maker(base_e)

    # ---- ae_sweep on model E: the latency matrix, the naive arm, workers --
    rows = []
    kernels.reset_launches()
    t = time.perf_counter()
    tf_error = ae_sweep.sweep_model(model_e, [32, 2048], 40, rows,
                                    params=params_e, factory=make_e,
                                    min_inputs=40)
    tf_error = ae_sweep.sweep_model(model_e, [512], 40, rows,
                                    params=params_e, factory=make_e,
                                    min_inputs=40, naive_arm=True) or tf_error
    require_tool_launches(dict(kernels.launches), ("K1", "X1", "X2"),
                          "ae_sweep, model E")
    require(all(r["request_ms_async"] > 0 and r["examples_per_s"] > 0
                for r in rows if "batch" in r), "ae_sweep model E rows")
    require(rows[-2]["naive_device_step_ms"] > 0
            and rows[-2]["naive_request_ms_async"] > 0, "naive arm at 512")
    workers = []
    ae_sweep.workers_sweep(model_e, 2048, 40, [2, 4], workers,
                           params=params_e, factory=make_e)
    require([r["serve_workers"] for r in workers] == [2, 4]
            and all(r["examples_per_s"] > 0 for r in workers),
            "workers sweep rows")
    log(f"ae_sweep (model E): {time.perf_counter() - t:.1f} s")
    free_engines()

    # ---- bw_breakdown on model E at 2048 -----------------------------------
    t = time.perf_counter()
    kernels.reset_launches()
    bw = bw_breakdown.run(model_e, 2048, n_inputs=40, params=params_e,
                          factory=make_e)
    require_tool_launches(dict(kernels.launches), ("K1", "X1", "X2"),
                          "bw_breakdown, model E")
    require(len(bw["groups"]) == 4 and bw["full_step_ms"] > 0,
            "bw_breakdown rows")
    print_json(f"bw_breakdown (model E, batch 2048; "
               f"{time.perf_counter() - t:.1f} s)", bw)
    free_engines()

    # ---- embedding_bw on model E ------------------------------------------
    eng = Engine(model_e, EngineConfig(), params=params_e)
    ebw = embedding_bw.embedding_only_bench(eng, base_e[0])
    require(ebw["detail"]["pooled_equals_plain"] is True
            and ebw["detail"]["pooled"]["x1_launches"] > 0,
            "embedding_bw: X1's pooled round == its plain version")
    print_json("embedding_bw (model E, batch 2048, its 2^23-row group)", ebw)
    del eng
    free_engines()

    # ---- ragged_bench: X1 at L = 16, 32, 64, 128 ---------------------------
    rag = ragged_bench.run()
    require([r["L"] for r in rag["rungs"]] == [16, 32, 64, 128]
            and all(r["max_abs_err"] == 0.0 and r["x1_launches"] == 24
                    for r in rag["rungs"]),
            "ragged_bench: X1 == its plain version at every rung")
    print_json("ragged_bench (X1 == its plain version at every rung)", rag)
    free_engines()

    # ---- entry() and dryrun_multichip(1) -----------------------------------
    from recom_tpu_torch.models import make_random_batch

    fn, args = entry.entry()
    kernels.reset_launches()
    got = fn(*args).cpu().numpy()
    counts = dict(kernels.launches)
    require_launches(counts, ("K1", "X1"), "entry()",
                     exactly={"K1": 1, "X1": 1})
    flagship = entry._flagship()
    want = Engine(flagship, EngineConfig()).predict(
        make_random_batch(flagship, 128, seed=0))["output"]
    require(got.shape == (128, 1) and np.array_equal(got, want),
            "entry() != Engine.predict on the same batch")
    log(f"entry(): output [128, 1] == Engine.predict's on the same batch; "
        f"launches {dict((k, n) for k, n in counts.items() if n)}")
    print_json("dryrun_multichip(1)", entry.dryrun_multichip(1))
    del fn, args
    free_engines()

    # ---- model F, then ae_sweep and benchmark on it ------------------------
    f = model_f_phase(torch)
    base_f = [f["batches"][2048], make_random_batch(f["model"], 2048,
                                                    seed=40)]
    make_f = batch_maker(base_f)
    kernels.reset_launches()
    t = time.perf_counter()
    f_tf_error = ae_sweep.sweep_model(f["model"], [32, 512, 2048], 40,
                                      rows, params=f["params"],
                                      factory=make_f, min_inputs=40)
    require_tool_launches(dict(kernels.launches), ("K1", "X1", "X2"),
                          "ae_sweep, model F")
    log(f"ae_sweep (model F): {time.perf_counter() - t:.1f} s")
    doc = {"sweep": rows, "throughput_sweep": workers}
    if tf_error or f_tf_error:
        doc["tf_baseline"] = tf_error or f_tf_error
    print_json("ae_sweep (models E and F)", doc)
    free_engines()

    profile_dir = os.path.join(tempfile.gettempdir(), "chip_smoke_profile")
    kernels.reset_launches()
    res = benchmark.run_benchmark(
        f["model"], batch_size=2048, num_iterations=32, serve_workers=2,
        profile=True, profile_dir=profile_dir, params=f["params"],
        batch_factory=lambda seed: fresh_batch(base_f[seed % 2], 2048, seed),
        warmup=2)
    require_tool_launches(dict(kernels.launches), ("K1", "X1", "X2"),
                          "benchmark, model F")
    prof = res["profile"]
    require(os.path.exists(os.path.join(profile_dir, "trace.json")),
            "benchmark --profile wrote no trace")
    if isinstance(prof, str):
        log(f"benchmark --profile on the card: {prof}")
    else:
        require(bool(prof["top_device_ops"])
                and all(o["name"] for o in prof["top_device_ops"]),
                "benchmark --profile: the top device ops are named")
    print_json("benchmark (model F, batch 2048, 2 workers, --profile)", res)
    free_engines()
    return dict(f_results=f["results"], f_counts=f["counts"],
                ragged=rag["rungs"])


def overwrite_freed(torch, streams) -> list:
    """Write -1 over every free block of the caching allocator's small pool
    on each of ``streams``: 512-byte tensors until the pool reserves a new
    segment (a free block of that stream would have been taken first).
    Returns the tensors, to be held while the freed memory must stay
    overwritten."""
    stat = "reserved_bytes.small_pool.current"
    junk = []
    for stream in streams:
        with torch.cuda.stream(stream):
            before = torch.cuda.memory_stats()[stat]
            for k in range(1, 1 << 20):
                junk.append(torch.full((128,), -1, dtype=torch.int32,
                                       device="cuda"))
                if k % 256 == 0 and torch.cuda.memory_stats()[stat] > before:
                    break
    torch.cuda.synchronize()
    return junk


def evict_plan_caches(torch, streams) -> list:
    """Clear the bounded caches of device plan arrays that kernel launches
    point into (X1b's work items, the partition's member rows) and write
    over the memory they free (``overwrite_freed``): a captured graph that
    did not hold its own would then read junk on replay."""
    import gc

    from recom_tpu_torch.ops import item_lists, lookup_gather

    lookup_gather._x1b_work_on.cache_clear()
    item_lists._info_on.cache_clear()
    gc.collect()
    return overwrite_freed(torch, streams)


def train_program_gate(torch, graphed, eager, cases, what: str,
                       backward) -> dict:
    """The captured training step against the eager one (ROADMAP item 19).
    ``graphed`` steps through its programs (one captured CUDA graph per
    shape signature, ``Trainer._programs``); ``eager``, built from the same
    params and optimizer with ``_capture = None``, runs each step one
    Python launch at a time.  At each (batch size, base batch) of
    ``cases``: three steps on the base's rows in three orders, each with
    its own labels (the signature's capture, then two replays that must
    load their inputs), all of ``eager``'s first, then all of
    ``graphed``'s.  Every loss ``==`` as bits; then every param and every
    optimizer state leaf ``==`` as bits.  Each program's kernel nodes, read
    back from its graph (``graphs.graph_launches``), are the launches its
    capture recorded, among them the backward kernels ``backward``, and
    every step counts exactly those.  After each capture the plan caches
    are cleared and the memory they free overwritten
    (``evict_plan_caches``), so the two replays show that the program holds
    the plan arrays its launches read (``Program.kept``).  Returns the
    readings: the losses and launch counts of ``graphed``'s steps, the
    first step of each signature and the replayed ones (host ms, ending in
    the loss read), and each trainer's reserved device memory over its
    steps (the overwrite's few small blocks among them)."""
    import numpy as np

    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.runtime.graphs import Program, graph_launches
    from recom_tpu_torch.utils.tree import tree_leaves

    require(graphed._capture is not None and eager._capture is None,
            f"{what}: one captured trainer and one eager")
    rng = np.random.default_rng(77)
    steps = [(bs, shuffled(base, bs, seed=1000 * k + bs),
              rng.integers(0, 2, bs).astype(np.float32))
             for bs, base in cases for k in range(3)]
    read = {"first_step_ms": {}, "replayed_step_ms": {}, "counts": [],
            "losses": []}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_reserved()
    want = [eager.step(b, lab) for _, b, lab in steps]
    torch.cuda.synchronize()
    read["eager_reserved_gib"] = (torch.cuda.memory_reserved()
                                  - base_mem) / 2**30
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_reserved()
    for i, (bs, b, lab) in enumerate(steps):
        kernels.reset_launches()
        t = time.perf_counter()
        read["losses"].append(graphed.step(b, lab))
        ms = (time.perf_counter() - t) * 1e3
        counts = {k: n for k, n in kernels.launches.items() if n}
        prog = graphed._programs.get(
            (graphed.engine.prepare(b).signature, "train"))
        require(isinstance(prog, Program), f"{what}, batch {bs}: no "
                "captured program for the step's signature")
        require(counts == prog.launches, f"{what}, batch {bs}, step "
                f"{i % 3 + 1}: launches {counts}, the program holds "
                f"{prog.launches}")
        read["counts"].append(counts)
        key = "first_step_ms" if i % 3 == 0 else "replayed_step_ms"
        read[key].setdefault(bs, []).append(ms)
        if i % 3 == 0:
            require(bool(prog.kept) or not (counts.get("X1b")
                                            or counts.get("Part")),
                    f"{what}, batch {bs}: the program holds none of the "
                    "plan arrays its X1b / Part launches read")
            junk = evict_plan_caches(torch, [torch.cuda.current_stream(),
                                             graphed._capture.stream])
        elif i % 3 == 2:
            del junk
    torch.cuda.synchronize()
    read["captured_reserved_gib"] = (torch.cuda.memory_reserved()
                                     - base_mem) / 2**30
    require(len(graphed._programs) == len(cases), f"{what}: "
            f"{len(graphed._programs)} programs for {len(cases)} signatures")
    for prog in graphed._programs.values():
        held = graph_launches(prog.graph.raw_cuda_graph())
        require(held == prog.launches and all(
            prog.launches.get(k, 0) >= 1 for k in backward),
            f"{what}: a program's kernel nodes {held}, its recorded "
            f"launches {prog.launches}, backward kernels {backward}")
    bits = lambda x: np.float64(x).tobytes()
    bad = [i for i, (g, w) in enumerate(zip(read["losses"], want))
           if bits(g) != bits(w)]
    require(not bad, f"{what}: captured losses != eager at steps {bad}: "
            f"{[(read['losses'][i], want[i]) for i in bad[:3]]}")

    def same(x, y):
        return torch.equal(x.detach().view(torch.int32),
                           y.detach().view(torch.int32))

    leaves = list(zip(tree_leaves(graphed.params), tree_leaves(eager.params)))
    bad = [i for i, (x, y) in enumerate(leaves) if not same(x, y)]
    require(not bad, f"{what}: params {bad} differ from the eager "
            "trainer's after the steps")
    state = list(zip(graphed.optimizer.state_tensors(),
                     eager.optimizer.state_tensors()))
    bad = [i for i, (x, y) in enumerate(state)
           if not (same(x, y) if isinstance(x, torch.Tensor) else x == y)]
    require(not bad, f"{what}: optimizer state leaves {bad} differ from "
            "the eager trainer's after the steps")
    log(f"{what}: captured training steps == eager as bits (3 steps at "
        f"each of batch {[bs for bs, _ in cases]}: every loss, {len(leaves)}"
        f" params, {len(state)} optimizer state leaves; the plan caches "
        f"cleared and their freed memory overwritten after each capture); "
        f"{len(cases)} "
        f"programs, each graph's kernel nodes == its recorded launches "
        f"({prog.launches} at batch {cases[-1][0]}), counted by each step; "
        f"first step of a signature (eager pass + capture) ms "
        + ", ".join(f"{bs}: {v[0]:.1f}" for bs, v in
                    read["first_step_ms"].items())
        + "; replayed ms " + ", ".join(
            f"{bs}: {statistics.median(v):.2f}" for bs, v in
            read["replayed_step_ms"].items())
        + f"; reserved memory over the steps: eager "
        f"{read['eager_reserved_gib']:.3f} GiB, captured "
        f"{read['captured_reserved_gib']:.3f} GiB")
    return read


def step_times(torch, pair, name: str, cases) -> dict:
    """Training step times of a (captured, eager) pair of Trainers on the
    same model (``train_program_gate``'s).  For each (batch size, batch,
    labels): the median step time over 6 rounds, the two trainers in
    turns (host clock around ``Trainer.step``, which ends in the loss
    read: host prep + H2D + forward + backward + optimizer); the eager
    step's forward / backward / optimizer device split (CUDA events,
    median of 5); and the captured step's device time, its graph
    replayed alone between CUDA events (mean of 5), queued behind a sleep
    kernel and host-paced.  Returns the readings."""
    graphed, eager = pair
    read = {}
    for bs, batch, labels in cases:
        for tr in pair:            # a new signature captures here
            tr.step(batch, labels)
        host = {"eager": [], "captured": []}
        for _ in range(6):
            for kind, tr in (("eager", eager), ("captured", graphed)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                tr.step(batch, labels)
                torch.cuda.synchronize()
                host[kind].append((time.perf_counter() - t) * 1e3)
        parts = []
        for _ in range(5):
            prepared = eager.engine.prepare(batch)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            eager.optimizer.zero_grad(set_to_none=True)
            loss = eager.loss(prepared, labels)
            ev[1].record()
            loss.backward()
            ev[2].record()
            eager.optimizer.step()
            ev[3].record()
            torch.cuda.synchronize()
            parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        fwd, bwd, opt = (statistics.median(p[i] for p in parts)
                         for i in range(3))
        prog = graphed._programs[(graphed.engine.prepare(batch).signature,
                                  "train")]
        queued = time_ms(torch, prog.graph.replay, iters=5, warmup=1)
        paced = time_ms(torch, prog.graph.replay, iters=5, warmup=1,
                        queued=False)
        e, c = (statistics.median(host[k]) for k in ("eager", "captured"))
        read[bs] = {"eager_ms": e, "captured_ms": c, "forward_ms": fwd,
                    "backward_ms": bwd, "optimizer_ms": opt,
                    "replay_queued_ms": queued, "replay_paced_ms": paced}
        log(f"{name}: training step batch {bs}: median eager {e:.3f} ms "
            f"(min {min(host['eager']):.3f}, max {max(host['eager']):.3f}), "
            f"captured {c:.3f} ms (min {min(host['captured']):.3f}, max "
            f"{max(host['captured']):.3f}), 6 steps each in turns; eager "
            f"device split (CUDA events, median of 5): forward {fwd:.3f} "
            f"ms, backward {bwd:.3f} ms, optimizer {opt:.3f} ms (sum "
            f"{fwd + bwd + opt:.3f}); the captured step's graph replayed "
            f"alone: {queued:.3f} ms queued, {paced:.3f} ms host-paced "
            "(mean of 5)")
    return read


# ---------------------------------------------------------------------------
# Serving on a mesh of ranks that share the one card over gloo
# ---------------------------------------------------------------------------

# Each world's layouts, run in turn by every rank: (label, mesh shape,
# EngineConfig fields, pooled gate: "==" or "1e-6").  Model E at full width
# in the default config otherwise (use_pallas=True, f32 tables); the wire is
# off on a mesh, so X2 does not run.
MESH_WORLDS = {
    2: (
        ("a2a, chunks 1", (1, 2),
         dict(shard_comm="all_to_all", a2a_chunks=1), "=="),
        ("a2a, chunks 2, dim split", (1, 2),
         dict(shard_comm="all_to_all", a2a_chunks=2, dim_shard_above=4),
         "=="),
        ("psum", (1, 2), dict(shard_comm="psum"), "1e-6"),
        ("data parallel", (2, 1), dict(), "=="),
    ),
    4: (
        ("a2a, chunks 2", (2, 2), dict(shard_comm="all_to_all"), "=="),
    ),
}
# the layout whose engine also takes the overflow, update and X1-role runs
MESH_MAIN = "a2a, chunks 2, dim split"
MESH_TIMEOUT_S = 900


def mesh_launches(shape, cfg) -> dict:
    """The launches one predict of model E implies on each rank: K1 once
    (the one-hot group, on the rank's data slice); X1 once for the gather
    groups (replicated, column-split, and the psum path's partial sums),
    and once more to pool the rows the all-to-all exchange returned; X2
    none (no wire on a mesh)."""
    a2a = shape[1] > 1 and cfg.get("shard_comm") == "all_to_all"
    return {"K1": 1, "X1": 2 if a2a else 1}


def save_mesh_inputs(np_params, batches, refs, path: str) -> None:
    """Model E's params as one ``.npy`` a table (each rank maps them with
    ``mmap_mode="r"``: the host keeps one page-cached copy), the tower as
    an npz, and the batches and the single-device references pickled."""
    import os
    import pickle

    import numpy as np

    names = sorted(np_params["tables"])
    os.makedirs(os.path.join(path, "tables"))
    for i, name in enumerate(names):
        np.save(os.path.join(path, "tables", f"{i}.npy"),
                np.asarray(np_params["tables"][name]))
    flat = {f"{k}/{i}/{wb}": l[wb]
            for k, layers in np_params["tower"].items()
            for i, l in enumerate(layers) for wb in ("w", "b")}
    np.savez(os.path.join(path, "tower.npz"), **flat)
    with open(os.path.join(path, "inputs.pkl"), "wb") as f:
        pickle.dump({"names": names, "batches": batches, "refs": refs}, f)


def load_mesh_inputs(path: str):
    """(params with mmap'd tables, batches, references): the inverse of
    ``save_mesh_inputs``."""
    import os
    import pickle

    import numpy as np

    with open(os.path.join(path, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    tables = {name: np.load(os.path.join(path, "tables", f"{i}.npy"),
                            mmap_mode="r")
              for i, name in enumerate(inputs["names"])}
    tower = {}
    with np.load(os.path.join(path, "tower.npz")) as z:
        for key in z.files:
            k, i, wb = key.rsplit("/", 2)
            layers = tower.setdefault(k, [])
            while len(layers) <= int(i):
                layers.append({})
            layers[int(i)][wb] = z[key]
    return {"tables": tables, "tower": tower}, inputs["batches"], \
        inputs["refs"]


def mesh_pooled_gate(out, ref, gate: str, what: str) -> None:
    """Pooled outputs of every column against the single-device Engine's:
    ``==``, or within 1e-6 (the psum path)."""
    import numpy as np

    require(set(out["pooled"]) == set(ref["pooled"]), f"{what}: columns")
    for c, r in ref["pooled"].items():
        if gate == "==":
            require(np.array_equal(out["pooled"][c], r),
                    f"{what}: pooled column {c} != the single-device "
                    "Engine's")
        else:
            np.testing.assert_allclose(out["pooled"][c], r, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{what}: {c}")


def mesh_output_gate(out, ref, gate: str, what: str) -> str:
    """The output against the single-device Engine's: ``==`` under every
    gate but psum (a row's tower bits do not depend on the batch it rides
    in, ROW_CHUNK); where it differs, a finding, and rtol 1e-4 / atol
    1e-5.  Returns what held."""
    import numpy as np

    if gate == "==" and np.array_equal(out["output"], ref["output"]):
        return "=="
    rows = int((out["output"] != ref["output"]).any(axis=1).sum())
    np.testing.assert_allclose(out["output"], ref["output"], rtol=1e-4,
                               atol=1e-5, err_msg=what)
    if gate == "==":
        log(f"FINDING {what}: {rows} output rows differ in bits from the "
            "single-device Engine's; within rtol 1e-4 / atol 1e-5")
    return f"rtol 1e-4 ({rows} rows differ)"


def x1_bytes(args) -> float:
    """The bytes X1 must move for one ``group_pooled`` argument tuple with
    no caps (the mesh roles): ids, weights, the distinct rows read and the
    f32 output, each once."""
    import torch

    table, ids, offs = args[0], args[1], args[2]
    cc, bp, _ = ids.shape
    valid = ids >= 0
    rows = ids.long() + torch.as_tensor(offs, device=ids.device).long()[
        :, None, None]
    uniq = torch.unique(rows[valid]).numel()
    w = args[4] if len(args) > 4 else None
    return (ids.numel() * 4 + uniq * table.shape[1] * table.element_size()
            + bp * cc * table.shape[1] * 4
            + (0 if w is None else w.numel() * 4))


def x1_role(torch, label: str, args) -> dict:
    """X1 in one mesh role at the path's shapes: the kernel held to its
    plain version (``==``), timed warm and with L2 flushed, beside the
    plain version, ``F.embedding_bag`` (the same sums, missing slots at
    weight 0; MEAN / SQRTN groups have none) and its bytes bound."""
    import torch.nn.functional as F

    from recom_tpu_torch.ops.kernels import launches
    from recom_tpu_torch.ops.lookup_gather import _plain, group_pooled

    before = launches["X1"]
    with torch.inference_mode():
        got = group_pooled(*args)
        plain = _plain(*args)
        torch.cuda.synchronize()
        require(launches["X1"] == before + 1, f"{label}: X1 launched")
        err = float((got - plain).abs().max()) if got.numel() else 0.0
        require(bool((got == plain).all()), f"{label}: X1 != its plain "
                f"version (max abs err {err})")
        table, ids = args[0], args[1]
        cc, bp, ll = ids.shape
        lib = None
        if not bool(((args[3] == 1) | (args[3] == 2)).any()):
            valid = ids >= 0
            safe = torch.where(valid, ids, torch.zeros_like(ids)).long() + \
                torch.as_tensor(args[2], device=ids.device).long()[:, None,
                                                                    None]
            w = valid.float() if args[4] is None else args[4] * valid
            bag_in = safe.permute(1, 0, 2).reshape(bp * cc, ll).contiguous()
            bag_w = w.permute(1, 0, 2).reshape(bp * cc, ll).contiguous()
            lib_fn = lambda: F.embedding_bag(bag_in, table, mode="sum",
                                             per_sample_weights=bag_w)
            lib = time_ms(torch, lib_fn)
        kern = lambda: group_pooled(*args)
        ms = time_ms(torch, kern)
        cold = time_cold_ms(torch, kern)
        plain_ms = time_ms(torch, lambda: _plain(*args), iters=5, warmup=1)
    bms, by = bound_ms(x1_bytes(args))
    rec = dict(name=label, ms=ms, cold_ms=cold, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, library_ms=lib, max_abs_err=err,
               share=bms / ms,
               shape=f"ids [{cc}, {bp}, {ll}], table [{table.shape[0]}, "
               f"{table.shape[1]}] -> [{bp}, {cc}, {table.shape[1]}]")
    log(f"  X1 as {label} ({rec['shape']}): {ms:.4f} ms warm, {cold:.4f} ms "
        f"cold L2, plain {plain_ms:.4f} ms, embedding_bag "
        f"{'none' if lib is None else f'{lib:.4f} ms'}, bound {bms:.4f} ms "
        f"({by}, share {bms / ms:.0%}); == its plain version")
    return rec


def x1_mesh_edges(torch) -> None:
    """X1 in its two mesh roles against its plain version on edge inputs,
    on the card: the all-to-all pool (entries at the appended zero row, pad
    slots, all-pad bags, weights, SUM / MEAN / SQRTN, chunked buffers) and
    the psum path's partial sums (ids of other model ranks masked, SUM,
    weights, bags with no id of the rank)."""
    import numpy as np

    from recom_tpu_torch.ops.lookup_gather import _plain, group_pooled
    from recom_tpu_torch.parallel.all_to_all_lookup import (
        a2a_route,
        pool_args,
    )
    from recom_tpu_torch.parallel.sharded_lookup import psum_partial_args

    dev = torch.device("cuda")
    n = zero_row = 0
    for seed, (c, bp, ll, d, m, factor, chunks) in enumerate((
            (3, 64, 12, 32, 2, 0.05, 1), (3, 64, 12, 32, 2, 0.05, 2),
            (4, 40, 5, 8, 4, 0.3, 3), (2, 16, 33, 3, 2, 1.0, 2),
            (3, 32, 1, 64, 2, 0.5, 1))):
        rng = np.random.default_rng(100 + seed)
        vocab = 50
        ids = rng.integers(0, vocab, (c, bp, ll)).astype(np.int32)
        ids[rng.random(ids.shape) < 0.3] = -1
        ids[:, :3] = -1                                   # all-pad bags
        w = rng.random(ids.shape).astype(np.float32)
        w[:, 3] = 0.0                                     # zero-weight bags
        codes = np.arange(c) % 3                          # SUM, MEAN, SQRTN
        offs = (np.arange(c) * vocab).astype(np.int32)
        t_ids = torch.from_numpy(ids).to(dev)
        t_w = torch.from_numpy(w).to(dev)
        t_offs = torch.from_numpy(offs).to(dev)
        shard_rows = -(-c * vocab // m)
        for k in range(m):
            # the routing queues its work with no host sync
            torch.cuda.set_sync_debug_mode("error")
            try:
                route = a2a_route(t_ids, t_offs, shard_rows, m, k, factor)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            cap = route["cap"]
            buf = torch.randn((m * cap + 1, d), device=dev)
            buf[-1] = 0.0
            zero_row += int((route["pos"] == m * cap).sum())
            for weights in (None, t_w):
                args = pool_args(buf, route, m, chunks, codes, weights,
                                 weights is not None, k)
                got, plain = group_pooled(*args), _plain(*args)
                require(bool((got == plain).all()),
                        f"X1 a2a pool edge case {seed}, rank {k}: != plain")
                args, _ = psum_partial_args(
                    torch.randn((shard_rows, d), device=dev), t_ids, offs, m,
                    k, weights)
                got, plain = group_pooled(*args), _plain(*args)
                require(bool((got == plain).all()),
                        f"X1 psum partial edge case {seed}, rank {k}: != "
                        "plain")
                n += 2
    torch.cuda.synchronize()
    require(zero_row > 0, "the edge cases send entries to the zero row")
    log(f"X1 mesh roles: {n} edge cases (routed with no host sync; a2a pool "
        f"with {zero_row} zero-row entries, "
        "pads, all-pad bags, weights, SUM / MEAN / SQRTN, chunked buffers; "
        "psum partials with other ranks' ids masked) == the plain version")


# ---------------------------------------------------------------------------
# Training on a mesh of ranks that share the one card over gloo
# ---------------------------------------------------------------------------

# Each world's training layouts, after its serving ones: (label, mesh
# shape, EngineConfig fields, step-1 loss gate).  Model E at full width in
# the default config otherwise, dlrm_optimizer(tower_lr=1e-5) (the random
# towers overshoot at 1e-3), 3 steps of 2048 rows against the single-device
# card Trainer on the same params, batches and labels.
MESH_TRAIN = {
    2: (
        ("train a2a, chunks 1", (1, 2),
         dict(shard_comm="all_to_all", a2a_chunks=1), "=="),
        ("train psum", (1, 2), dict(shard_comm="psum"), "1e-6"),
    ),
    4: (
        ("train a2a, chunks 2, dim split", (2, 2),
         dict(shard_comm="all_to_all", a2a_chunks=2, dim_shard_above=4),
         "=="),
    ),
}
MESH_TRAIN_OPT = dict(tower_lr=1e-5)
MESH_TRAIN_STEPS = 3


def mesh_train_launches(cfg) -> dict:
    """The launches one training step of model E implies on each rank: the
    forward's (``mesh_launches``), K3a once (the one-hot group's backward
    on the rank's data slice), X1b once for the gather groups (the psum
    path's partial sums on the stripe among them), and under the exchange
    twice more: its pool into the receive buffer and the owner's scatter
    into the stripe; one partition launch (Part) in the forward for all
    of X1b's groups (item_lists.StepLists)."""
    a2a = cfg.get("shard_comm") == "all_to_all"
    return {"K1": 1, "X1": 2 if a2a else 1, "K3a": 1,
            "X1b": 3 if a2a else 1, "Part": 1}


def big_group(eng):
    """(index, group) of model E's one striped group, the 2^23-row lists."""
    (gi, g), = [(i, g) for i, g in enumerate(eng.compiled.groups)
                if g.stacked_rows > eng.config.shard_rows_above]
    return gi, g


def touched_rows(eng, batch):
    """The stacked rows of the striped group that ``batch`` reads (ids
    clamped to their caps, offset), sorted, as int64."""
    import numpy as np

    from recom_tpu_torch.runtime.host_prep import prepare_batch

    gi, g = big_group(eng)
    ids = prepare_batch(eng.compiled, batch).arrays["groups"][gi]["host_ids"]
    caps = np.asarray(g.vocab_caps, np.int64)[:, None, None]
    offs = np.asarray(g.row_offsets, np.int64)[:, None, None]
    rows = np.minimum(ids.astype(np.int64), caps) + offs
    return np.unique(rows[ids >= 0])


def mesh_train_refs(torch, model, np_params, base) -> dict:
    """The single-device card Trainer (default config, MESH_TRAIN_OPT) on
    MESH_TRAIN_STEPS batches of 2048 (``base`` and two ``fresh_batch``es,
    seeded labels): its losses; step 1's gradients (the striped group's at
    the rows the batch touches, every other leaf whole); the params after
    the steps (the striped group's at the rows any batch touched).  The
    5.37 GB dense gradient never leaves the card."""
    import numpy as np

    from recom_tpu_torch import EngineConfig, Trainer
    from recom_tpu_torch.train import dlrm_optimizer

    batches = [base] + [fresh_batch(base, 2048, seed=70 + i)
                        for i in range(MESH_TRAIN_STEPS - 1)]
    labels = [np.random.default_rng(80 + i).integers(0, 2, 2048)
              .astype(np.float32) for i in range(MESH_TRAIN_STEPS)]
    tr = Trainer(model, EngineConfig(),
                 optimizer=dlrm_optimizer(**MESH_TRAIN_OPT), params=np_params)
    # eager, as the mesh Trainers step: a captured step keeps no .grad,
    # and step 1's gradients are read below
    tr._capture = None
    eng = tr.engine
    gi, g = big_group(eng)
    big = str(g.gid)
    rows1 = touched_rows(eng, batches[0])
    idx1 = torch.from_numpy(rows1).to(eng.device)

    def host(t):
        return t.detach().cpu().numpy()

    losses = [tr.step(batches[0], labels[0])]
    params = tr.params
    grads = {
        "big": host(params["stacked"][big].grad[idx1]),
        "stacked": {gid: host(p.grad) for gid, p in params["stacked"].items()
                    if gid != big},
        "tower": {key: [{wb: host(l[wb].grad) for wb in ("w", "b")}
                        for l in layers]
                  for key, layers in params["tower"].items()},
    }
    for b, lab in zip(batches[1:], labels[1:]):
        losses.append(tr.step(b, lab))
    rows = np.unique(np.concatenate([touched_rows(eng, b) for b in batches]))
    idx = torch.from_numpy(rows).to(eng.device)
    final = {
        "big": host(params["stacked"][big][idx]),
        "stacked": {gid: host(p) for gid, p in params["stacked"].items()
                    if gid != big},
        "tower": {key: [{wb: host(l[wb]) for wb in ("w", "b")}
                        for l in layers]
                  for key, layers in params["tower"].items()},
    }
    peak = torch.cuda.max_memory_allocated() / 2**30
    del tr, eng, params, idx, idx1
    free_engines()
    return {"batches": batches, "labels": labels, "losses": losses,
            "big_gid": big, "rows1": rows1, "grads": grads, "rows": rows,
            "final": final, "peak_gib": peak}


def mesh_train_checks(torch, tr, ref, what: str, step: int) -> dict:
    """The rank's leaves against the single-device references: after step
    1 its gradients (``step`` 1), after the last step its params.  The
    striped leaf at the rows the batches touched (atol 1e-5), its other
    rows +0.0 (gradients, counted) or unchanged (params, 64 rows against
    the mmap'd tables); a column-split leaf's columns and every replicated
    leaf whole (gradients rtol 1e-5 / atol 1e-6; params atol 1e-5)."""
    import numpy as np

    eng = tr.engine
    m, k = eng._model_split()
    big = ref["big_gid"]
    grads = step == 1
    want = ref["grads"] if grads else ref["final"]
    rows = ref["rows1"] if grads else ref["rows"]
    rtol, atol = (1e-5, 1e-6) if grads else (0.0, 1e-5)
    out = {}
    for g in eng.compiled.groups:
        gid = str(g.gid)
        leaf = tr.params["stacked"][gid]
        t = leaf.grad if grads else leaf.detach()
        if gid == big:
            mine = rows % m == k
            local = torch.from_numpy(rows[mine] // m).to(t.device)
            np.testing.assert_allclose(
                t[local].cpu().numpy(), want["big"][mine], rtol=0.0,
                atol=1e-5, err_msg=f"{what}: striped group {gid} at its "
                "touched rows")
            touched = torch.zeros(t.shape[0], dtype=torch.bool,
                                  device=t.device)
            touched[local] = True
            if grads:
                nz = (t.view(torch.int32) != 0).any(dim=1)
                bad = int((nz & ~touched).sum())
                require(bad == 0, f"{what}: {bad} untouched stripe rows of "
                        "the gradient are not +0.0")
                out["stripe_rows_touched"] = int(mine.sum())
                out["stripe_rows"] = int(t.shape[0])
            else:
                free = (~touched).nonzero()[:, 0]
                pick = free[torch.arange(64, device=t.device)
                            * (free.numel() - 1) // 63]
                out["unchanged_rows_checked"] = int(pick.numel())
                out["sample"] = pick.cpu().numpy()
            continue
        w = want["stacked"][gid]
        if eng.layout(g) == "columns":
            cw = w.shape[1] // m
            w = w[:, k * cw:(k + 1) * cw]
        np.testing.assert_allclose(t.detach().cpu().numpy(), w, rtol=rtol,
                                   atol=atol, err_msg=f"{what}: group {gid} "
                                   f"({eng.layout(g)})")
    for key, layers in tr.params["tower"].items():
        for i, layer in enumerate(layers):
            for wb in ("w", "b"):
                t = layer[wb].grad if grads else layer[wb].detach()
                np.testing.assert_allclose(
                    t.cpu().numpy(), want["tower"][key][i][wb], rtol=rtol,
                    atol=atol, err_msg=f"{what}: tower {key}[{i}].{wb}")
    return out


def stripe_sample_initial(eng, params, sample) -> "np.ndarray":
    """The initial values of the striped group's local rows ``sample`` of
    this rank, read from the mmap'd member tables."""
    import numpy as np

    m, k = eng._model_split()
    _, g = big_group(eng)
    out = np.zeros((len(sample), g.dim), np.float32)
    for j, r in enumerate(np.asarray(sample) * m + k):
        for mem in g.members:
            if mem.row_offset <= r < mem.row_offset + mem.vocab_size:
                out[j] = params["tables"][mem.table][r - mem.row_offset]
    return out


def collectives_p50(spans) -> dict:
    """{"<collective>/<axis>": p50 ms} of the span recorder's collective
    spans (each a host enqueue)."""
    return {k[len("collective."):]: v["p50_ms"]
            for k, v in spans.summary().items()
            if k.startswith("collective.")}


def mesh_train_layout(torch, rank: int, label: str, shape, cfg, gate: str,
                      mesh, model, params, ref) -> dict:
    """One training layout on this rank: the mesh Trainer stepped on the
    reference batches, each step split by host clock (synchronized) into
    forward, backward, the gradients' all_reduce over "data" and the
    optimizer; its launches asserted each step; step 1's loss (``gate``)
    and gradients and the params after the steps held to the single
    device's; the losses within rtol 1e-5."""
    import numpy as np

    from recom_tpu_torch import EngineConfig, Trainer
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.train import dlrm_optimizer, param_leaves
    from recom_tpu_torch.utils import spans

    t = time.perf_counter()
    tr = Trainer(model, EngineConfig(mesh_shape=shape, **cfg),
                 optimizer=dlrm_optimizer(**MESH_TRAIN_OPT), params=params,
                 mesh=mesh)
    torch.cuda.synchronize()
    rec = {"build_s": time.perf_counter() - t}
    want = mesh_train_launches(cfg)
    spans.enable()
    torch.cuda.reset_peak_memory_stats()
    losses, parts, counts = [], [], []
    for i, (b, lab) in enumerate(zip(ref["batches"], ref["labels"])):
        kernels.reset_launches()
        t0 = time.perf_counter()
        prepared = tr.engine.prepare(b)
        tr.optimizer.zero_grad(set_to_none=True)
        loss = tr.loss(prepared, lab)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        leaves = param_leaves(tr.params)
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        tr.reduce_grads([p.grad for p in leaves])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        tr.optimizer.step()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        got = {kk: n for kk, n in kernels.launches.items() if n}
        require(got == want, f"rank {rank} {label} step {i + 1}: launches "
                f"{got}, expected {want}")
        counts.append(got)
        losses.append(float(loss.detach()))
        parts.append([(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
                      (t4 - t3) * 1e3, (t4 - t0) * 1e3])
        if i == 0:
            rec["grads"] = mesh_train_checks(torch, tr, ref,
                                             f"rank {rank} {label}", 1)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["collectives"] = collectives_p50(spans)
    spans.disable()
    what = f"rank {rank} {label}"
    d_ax = shape[0]
    if gate == "==" and losses[0] == ref["losses"][0]:
        rec["loss1"] = "=="
    else:
        require(gate != "==" or d_ax > 1, f"{what}: step 1's loss "
                f"{losses[0]!r} != the single device's {ref['losses'][0]!r}")
        np.testing.assert_allclose(losses[0], ref["losses"][0], rtol=1e-6,
                                   err_msg=what)
        rec["loss1"] = (f"rtol 1e-6 (differs by "
                        f"{abs(losses[0] - ref['losses'][0]):.3g})")
        if gate == "==":
            log(f"FINDING {what}: step 1's loss sums {d_ax} data slices, "
                f"{losses[0]!r} against {ref['losses'][0]!r}")
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5,
                               err_msg=f"{what}: losses")
    fin = mesh_train_checks(torch, tr, ref, what, MESH_TRAIN_STEPS)
    leaf = tr.params["stacked"][ref["big_gid"]].detach()
    sample = torch.from_numpy(fin.pop("sample")).to(leaf.device)
    require(np.array_equal(leaf[sample].cpu().numpy(), stripe_sample_initial(
        tr.engine, params, sample.cpu().numpy())),
        f"{what}: untouched stripe rows changed")
    rec.update(losses=losses, launches=counts[-1], params=fin,
               step_ms={name: statistics.median(p[j] for p in parts)
                        for j, name in enumerate(
                            ("forward", "backward", "grad_all_reduce",
                             "optimizer", "step"))})
    return rec, tr


def x1b_role(torch, label: str, args, launches: str) -> dict:
    """X1b in one mesh role (``args``: one ``groups_pooled_grad`` group at
    the path's shapes): checked by ``check_backward`` (two runs, the second
    into NaN-filled outputs, give the same bits; those equal the wrapper on
    CPU copies; within 1e-5 of the terms' magnitudes of the plain version on
    the card), timed warm and with L2 flushed, beside the plain version on
    the card, ``torch.zeros`` + ``index_add_`` of precomputed contributions
    (the library yardstick) and its bound (the cotangent, ids, weights and
    the dense output, each once)."""
    from recom_tpu_torch.ops.lookup_gather import (
        group_pooled_grad_plain,
        groups_pooled_grad,
        slot_contributions,
        x1b_partition_groups,
    )

    g, num_rows, ids = args[0], args[1], args[2]
    weights = args[5] if len(args) > 5 else None
    d = g.shape[2]
    fn = lambda *a: groups_pooled_grad([a])[0]
    mag = (g.abs(),) + tuple(args[1:5]) + (
        None if weights is None else weights.abs(),) + tuple(args[6:])
    into = lambda a: groups_pooled_grad([a], out=[torch.full(
        (num_rows, d), float("nan"), device=g.device)])[0]
    err = check_backward(torch, f"X1b as {label}", fn,
                         group_pooled_grad_plain, args, mag, into)
    check_partition(torch, f"Part of X1b as {label}",
                    x1b_partition_groups([args]))
    rows, contrib = slot_contributions(g, ids, *args[3:])
    lib_fn = lambda: torch.zeros((num_rows, d), device=g.device).index_add_(
        0, rows, contrib)
    kern = lambda: fn(*args)
    ms = time_ms(torch, kern)
    cold = time_cold_ms(torch, kern)
    plain_ms = time_ms(torch, lambda: group_pooled_grad_plain(*args),
                       iters=5, warmup=1)
    lib = time_ms(torch, lib_fn)
    nbytes = (num_rows * d + g.numel() + ids.numel()
              + (0 if weights is None else weights.numel())) * 4
    bms, by = bound_ms(nbytes, 2.0 * contrib.numel())
    shape = (f"g [{g.shape[0]}, {g.shape[1]}, {d}], ids {list(ids.shape)} -> "
             f"[{num_rows}, {d}]")
    log(f"  X1b as {label} ({shape}): {ms:.4f} ms warm, {cold:.4f} ms cold "
        f"L2, plain {plain_ms:.4f} ms, library (torch.zeros + index_add_) "
        f"{lib:.4f} ms, bound {bms:.4f} ms ({by}, share {bms / ms:.0%}); "
        f"launches {launches}; == plain on CPU copies, max abs diff from "
        f"the card's plain version {err:.3g}; its partition (Part) == "
        "plain")
    return dict(name=label, ms=ms, cold_ms=cold, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib, max_abs_err=err,
                share=bms / ms, shape=shape, launches=launches)


def x1b_mesh_roles(torch, tr, batch, rank: int) -> list:
    """X1b's three mesh roles at model E's shapes on this layout (every
    rank routes and exchanges, collectively; rank 0 checks and times, the
    others wait): (a) the psum path's partial sums on the stripe, (b) the
    exchange's pool into the receive buffer, (c) the owner's gather,
    scattered into the stripe; each with a random cotangent."""
    import torch.distributed as dist

    from recom_tpu_torch.ops.lookup_gather import shared_rows_consts
    from recom_tpu_torch.parallel.all_to_all_lookup import (
        a2a_exchange,
        a2a_route,
        pool_args,
    )
    from recom_tpu_torch.parallel.sharded_lookup import psum_partial_args

    eng = tr.engine
    mesh = eng.mesh
    m, k = eng._model_split()
    gi, g = big_group(eng)
    c = eng._consts[g.gid]
    table = tr.params["stacked"][str(g.gid)].detach()
    rows = table.shape[0]
    chunks = eng.config.a2a_chunks
    with torch.no_grad():
        arrays = eng.to_device(eng.prepare(batch))
        ids, weights = eng.group_ids(g, arrays["groups"][gi])
        route = a2a_route(ids, c["row_offsets"], rows, m, k,
                          eng.config.a2a_capacity_factor, True, c["caps"])
        recv = mesh.all_to_all(route["send"], "model")
        buf = a2a_exchange(mesh, table, route, chunks)
        torch.cuda.synchronize()
    out = []
    if rank == 0:
        gen = torch.Generator(device="cuda").manual_seed(5)
        rand = lambda *s: torch.randn(s, device="cuda", generator=gen)
        pa, _ = psum_partial_args(table, ids, c["row_offsets"], m, k,
                                  weights, c["caps"])
        bp, cc = ids.shape[1], ids.shape[0]
        out.append(x1b_role(torch, "psum partial (stripe)", (
            rand(bp, cc, g.dim), rows) + tuple(pa[1:]),
            "0 more: it joins the gather groups' launch (X1b 1 a step; "
            "its lists in the step's one Part)"))
        po = pool_args(buf, route, m, chunks, c["codes"], weights,
                       c["weighted"], k)
        b_my = po[1].shape[1]
        out.append(x1b_role(torch, "a2a pool (receive buffer)", (
            rand(b_my, cc, g.dim), buf.shape[0]) + tuple(po[1:]),
            "1 more (X1b 3 a step; its lists in the step's one Part)"))
        zero, no_cap, flags = shared_rows_consts(1, "cuda")
        n = recv.numel()
        out.append(x1b_role(torch, "owner scatter (stripe)", (
            rand(n, 1, g.dim), rows, recv.reshape(1, n, 1), zero, zero,
            None, flags, no_cap),
            "1 more (X1b 3 a step; its lists in the step's one Part)"))
    dist.barrier()
    return out


def x1b_mesh_edges(torch) -> None:
    """X1b in its three mesh roles against its plain version on edge inputs
    (``check_backward``): the owner's scatter with every source rank's ids
    on one stripe row, row 0 of unused slots, heavy duplicates; the pool
    with pads, duplicate buffer rows (the dedup), entries at the zero row,
    SUM / MEAN / SQRTN, weights; the psum partials with other ranks' ids
    masked; stripes under and over one sparse range, d 3, 8, 32."""
    import numpy as np

    from recom_tpu_torch.ops import lookup_gather as lg
    from recom_tpu_torch.ops.lookup_gather import (
        group_pooled_grad_plain,
        groups_pooled_grad,
        shared_rows_consts,
    )

    dev = torch.device("cuda")
    fn = lambda *a: groups_pooled_grad([a])[0]
    n = 0
    for seed, (rows, d) in enumerate(((300, 3), (50_000, 8), (70_000, 32))):
        rng = np.random.default_rng(200 + seed)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        # (c): 2 source ranks x cap 96; half the slots ask one hot row,
        # some ask row 0, some are unfilled (-1), the rest heavy duplicates
        recv = rng.integers(0, 7, 192).astype(np.int32) * (rows // 7)
        recv[::2] = rows // 3
        recv[-30:-20] = 0
        recv[-20:] = -1
        zero, no_cap, flags = shared_rows_consts(1, "cuda")
        g = rng.standard_normal((192, 1, d)).astype(np.float32)
        cases = [(t(g), rows, t(recv.reshape(1, 192, 1)), zero, zero, None,
                  flags, no_cap)]
        # (b): pool positions into [m * cap + 1] rows, pads, duplicates,
        # the zero row; 3 columns SUM / MEAN / SQRTN, weighted; the last
        # buffer has 70 001 rows, one member of dense tiles (at most 4 rows
        # a slot), each tile reading only its own slots
        c, ll = 3, 5
        b, buf_rows = (40, 2 * 64 + 1) if seed < 2 else (1200, 70_001)
        pos = rng.integers(0, buf_rows // 6, (c, b, ll)).astype(np.int32)
        pos[rng.random(pos.shape) < 0.25] = -1
        pos[:, ::7] = buf_rows - 1
        pos[:, :2] = -1
        w = rng.random((c, b, ll)).astype(np.float32)
        z3, nc3, f3 = shared_rows_consts(c, "cuda")
        gb = rng.standard_normal((b, c, d)).astype(np.float32)
        for weights in (None, t(w)):
            cases.append((t(gb), buf_rows, t(pos), z3,
                          t(np.arange(c, dtype=np.int32)), weights,
                          t(np.array([1, 0, 1], np.uint8)), nc3))
        # (a): the stripe's local ids, another rank's masked to -1
        local = rng.integers(0, rows, (c, b, ll)).astype(np.int32)
        local[rng.random(local.shape) < 0.5] = -1
        local[:, 3] = rows - 1
        cases.append((t(gb), rows, t(local), z3, z3, t(w), f3, nc3))
        plan = lg.x1b_plan(buf_rows, d, [0], None, pos.size)
        require(bool((plan[plan[:, 3] >= 0, 4] == 1).all()),
                "the buffer: one member of dense tiles")
        for args in cases:
            w_ = args[5]
            mag = (args[0].abs(),) + tuple(args[1:5]) + (
                None if w_ is None else w_.abs(),) + tuple(args[6:])
            into = lambda a: groups_pooled_grad([a], out=[torch.full(
                (a[1], a[0].shape[2]), float("nan"), device=dev)])[0]
            check_backward(torch, f"X1b mesh edge case {seed}.{n}", fn,
                           group_pooled_grad_plain, args, mag, into)
            n += 1
    log(f"X1b mesh roles: {n} edge cases (owner scatter with one hot row "
        "from both source ranks, row 0 and unfilled slots; pool with pads, "
        "duplicate rows, the zero row, SUM / MEAN / SQRTN, weights, a 70 001-"
        "row buffer as one member of dense tiles; psum partials with masked ids; "
        "stripes of 300 / 50 000 / 70 000 rows, d 3 / 8 / 32) == the plain "
        "version on CPU copies, twice, into NaN-filled outputs")


def mesh_train_extras(torch, rank: int, world: int) -> dict:
    """The mesh tools and entry point in this world, on the card over
    gloo at small sizes: a world of 2 runs ``tools.scaling.sweep`` (model
    axes 1 and 2, both comms); a world of 4 ``entry.dryrun_multichip(4)``
    and ``tools.train_multi.run`` for 4 steps on (2, 2)."""
    from recom_tpu_torch import entry
    from recom_tpu_torch.tools import scaling, train_multi

    out = {}
    if world == 2:
        for comm in ("all_to_all", "psum"):
            out[f"scaling_{comm}"] = scaling.sweep(
                rows_per_shard=1 << 16, dim=32, batch=2048, n_columns=5,
                rowlen=12, iters=5, comm=comm, mesh_sizes=[1, 2], chunks=2,
                device="cuda:0", backend="gloo")
    else:
        out["dryrun"] = entry.dryrun_multichip(4, device="cuda:0",
                                               backend="gloo")
        out["train_multi"] = train_multi.run(
            steps=4, batch=256, lr=1e-3, mesh=(2, 2), eval_n=512,
            device="cuda:0", backend="gloo")
    return out


def mesh_rank(rank: int, world: int, store: str, path: str, outq,
              work) -> None:
    """One rank of a mesh world: join the gloo group through ``store``,
    run ``work(torch, rank, world, path)`` (``mesh_rank_work``, or
    ``fuzz_mesh_work``) and put (rank, ok, result or traceback) on
    ``outq``."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                world_size=world, rank=rank)
        outq.put((rank, True, work(torch, rank, world, path)))
    except BaseException:
        outq.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def mesh_rank_work(torch, rank: int, world: int, path: str) -> dict:
    """Every layout of ``MESH_WORLDS[world]`` on this rank: model E built
    from the mmap'd params (the rank reads only its stripe of the striped
    group), served at 512 and 2048 and held to the single-device Engine's
    results; launch counts asserted; the device forward and each
    collective timed (gloo through the host, one shared card).  On the
    main layout also the overflow policies, the updates and X1's mesh
    roles.  Then every training layout of ``MESH_TRAIN[world]``
    (``mesh_train_layout``; X1b's mesh roles on the first of the world of
    2) and the world's tools (``mesh_train_extras``).  Returns the records
    this rank measured."""
    import os

    import torch.distributed as dist

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.models import make_model_e
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.parallel import make_mesh
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.utils import spans

    params, batches, refs = load_mesh_inputs(path)
    model = make_model_e(seed=0)
    meshes = {}
    out = {"layouts": {}}
    for label, shape, cfg, gate in MESH_WORLDS[world]:
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, backend="gloo", device="cuda:0")
        mesh = meshes[shape]
        t = time.perf_counter()
        eng = Engine(model, EngineConfig(mesh_shape=shape, **cfg),
                     params=params, mesh=mesh)
        torch.cuda.synchronize()
        build = time.perf_counter() - t
        rec = {"build_s": build, "layout": [
            (g["gid"], g["layout"], g["backend"])
            for g in eng.stats_report()["groups"]],
            "memory_gib": torch.cuda.memory_allocated() / 2**30}
        want = mesh_launches(shape, cfg)
        for bs in (512, 2048):
            batch = batches[bs]
            kernels.reset_launches()
            got = eng.predict(batch, return_pooled=True)
            torch.cuda.synchronize()
            counts = {k: n for k, n in kernels.launches.items() if n}
            require(counts == want, f"rank {rank} {label} batch {bs}: "
                    f"launches {counts}, expected {want}")
            what = f"rank {rank} {label} batch {bs}"
            mesh_pooled_gate(got, refs[bs], gate, what)
            rec[f"output_{bs}"] = mesh_output_gate(got, refs[bs], gate, what)
            rec[f"launches_{bs}"] = counts
            # the queued device forward, host-paced (its collectives wait
            # on the host), and each collective's wall time
            prep = eng.prepare(batch)
            on_dev = eng.to_device(prep)
            spans.enable()
            with torch.inference_mode():
                rec[f"forward_ms_{bs}"] = time_ms(
                    torch, lambda: eng._forward(on_dev, prep.signature),
                    iters=5, warmup=2, queued=False)
            rec[f"collectives_{bs}"] = collectives_p50(spans)
            spans.disable()
        if label == MESH_MAIN:
            out.update(mesh_main_extras(torch, eng, model, params, batches,
                                        refs, rank))
        out["layouts"][label] = rec
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    import pickle

    with open(os.path.join(path, "train.pkl"), "rb") as f:
        tref = pickle.load(f)
    out["train"] = {}
    for label, shape, cfg, gate in MESH_TRAIN[world]:
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, backend="gloo", device="cuda:0")
        rec, tr = mesh_train_layout(torch, rank, label, shape, cfg, gate,
                                    meshes[shape], model, params, tref)
        if label == MESH_TRAIN[2][0][0]:
            tr.optimizer.zero_grad(set_to_none=True)
            rec["x1b_roles"] = x1b_mesh_roles(torch, tr, tref["batches"][0],
                                              rank)
        out["train"][label] = rec
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    t = time.perf_counter()
    out["extras"] = mesh_train_extras(torch, rank, world)
    out["extras_s"] = time.perf_counter() - t
    return out


def mesh_main_extras(torch, eng, model, params, batches, refs,
                     rank: int) -> dict:
    """On the main layout's engine: X1's two mesh roles timed (on rank 0,
    the other ranks waiting) at batch 2048; the forced overflow (capacity
    factor 0.01) under "recompute", "warn" and "raise", its count held to
    the plain routing's on CPU copies of the same ids; update_table_rows
    on a striped and a column-split table, read back through predict and
    export_params."""
    import numpy as np
    import torch.distributed as dist

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.parallel.all_to_all_lookup import (
        a2a_exchange,
        a2a_route,
        pool_args,
        table_rows,
    )
    from recom_tpu_torch.parallel.sharded_lookup import psum_partial_args
    from recom_tpu_torch.runtime.checkpoint import export_params
    from recom_tpu_torch.runtime.executor import Engine

    out = {}
    mesh = eng.mesh
    m, k = eng._model_split()
    big = [g for g in eng.compiled.groups if g.gid in eng._sharded_gids]
    require(len(big) == 1 and big[0].dim == 32, "one striped group, d = 32")
    g = big[0]
    c = eng._consts[g.gid]
    table = eng.device_params["stacked"][str(g.gid)]
    prep = eng.prepare(batches[2048])
    gi = eng.compiled.groups.index(g)
    with torch.inference_mode():
        arrays = eng.to_device(prep)
        ids, weights = eng.group_ids(g, arrays["groups"][gi])
        route = a2a_route(ids, c["row_offsets"], table_rows(table), m, k,
                          eng.config.a2a_capacity_factor, True, c["caps"])
        buf = a2a_exchange(mesh, table, route, eng.config.a2a_chunks)
        torch.cuda.synchronize()
    out["exchange"] = dict(slots=route["pos"].numel(),
                           ids=int((route["pos"] >= 0).sum()),
                           cap=route["cap"],
                           rows_bytes=int((buf.shape[0] - 1) * buf.shape[1]
                                          * 4))
    if rank == 0:
        psum_args, _ = psum_partial_args(table, ids, c["row_offsets"], m, k,
                                         weights, c["caps"])
        out["x1_roles"] = [
            x1_role(torch, "psum partial", psum_args),
            x1_role(torch, "a2a pool", pool_args(
                buf, route, m, eng.config.a2a_chunks, c["codes"], weights,
                c["weighted"], k)),
        ]
    dist.barrier()

    # ---- the forced overflow --------------------------------------------
    shape = tuple(mesh.shape.values())
    base = dict(mesh_shape=shape, shard_comm="all_to_all",
                a2a_capacity_factor=0.01)
    batch = batches[512]
    host = eng.shard_batch_arrays(eng.prepare(batch).arrays)
    cpu_ids = torch.from_numpy(host["groups"][gi]["host_ids"])
    want_ov = sum(int(a2a_route(cpu_ids, g.row_offsets, table_rows(table), m,
                                kk, 0.01, True, g.vocab_caps)["overflow"])
                  for kk in range(m))
    ov = {}
    for policy in ("recompute", "warn", "raise"):
        e2 = Engine(model, EngineConfig(a2a_overflow_policy=policy, **base),
                    params=params, mesh=mesh)
        kernels.reset_launches()
        try:
            got = e2.predict(batch, return_pooled=True)
            raised = None
        except RuntimeError as err:
            got, raised = None, str(err)
        torch.cuda.synchronize()
        counts = {kk: n for kk, n in kernels.launches.items() if n}
        got_ov = e2.stats.get("a2a_overflow")
        require(got_ov == want_ov, f"rank {rank} {policy}: overflow "
                f"{got_ov} != the plain routing's {want_ov} on CPU copies")
        if policy == "recompute":
            require(counts == {"K1": 2, "X1": 4},
                    f"rank {rank} recompute launches {counts}")
            require(e2.stats.get("a2a_recomputes") == 1, "one recompute")
            mesh_pooled_gate(got, refs[512], "==", f"rank {rank} recompute")
            mesh_output_gate(got, refs[512], "==", f"rank {rank} recompute")
        elif policy == "warn":
            require(got["a2a_overflow"] == want_ov, "warn keeps the count")
        else:
            require(raised is not None and "overflow" in raised,
                    f"rank {rank}: the raise policy did not raise")
        ov[policy] = dict(count=e2.stats.get("a2a_overflow"),
                          launches=counts, raised=raised is not None)
        del e2
        gc.collect()
        torch.cuda.empty_cache()
    out["overflow"] = dict(plain_count=want_ov, **ov)

    # ---- updates: a striped row and a column-split row -------------------
    upd = refs["updates"]
    for name, ids_u, vals in upd:
        eng.update_table_rows(name, ids_u, vals)
    got = eng.predict(batch, return_pooled=True)
    mesh_pooled_gate(got, refs["updated"], "==", f"rank {rank} updated")
    mesh_output_gate(got, refs["updated"], "==", f"rank {rank} updated")
    exp = export_params(eng, [u[0] for u in upd])
    for name, ids_u, vals in upd:
        t = exp["tables"][name]
        require(np.array_equal(t[ids_u], vals), f"export of {name}: "
                "updated rows")
        keep = np.setdiff1d(np.arange(0, t.shape[0], 997), ids_u)
        require(np.array_equal(t[keep], np.asarray(params["tables"][name])[
            keep]), f"export of {name}: other rows")
    out["updates"] = [(name, len(ids_u), eng.layout(
        [gg for gg in eng.compiled.groups
         if any(mm.table == name for mm in gg.members)][0]))
        for name, ids_u, _ in upd]
    return out


def run_mesh_world(world: int, path: str, work) -> list:
    """Spawn ``world`` ranks on the card (``spawn``: CUDA forbids ``fork``
    after its init), each running ``work``, a function of this module
    (``mesh_rank``), wait for each one's result, and stop them all.  A
    rank that fails or does not answer fails the run."""
    import multiprocessing as mp
    import os
    import queue

    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    store = os.path.join(path, f"store_{world}")
    procs = [ctx.Process(target=mesh_rank, args=(r, world, store, path,
                                                 outq, work))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        while len(got) < world:
            try:
                rank, ok, res = outq.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"chip_smoke: mesh world {world}: ranks "
                        f"{sorted(got)} answered, ranks {dead} ended "
                        f"without an answer (exit codes "
                        f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"chip_smoke: mesh world {world}, rank "
                                   f"{rank} failed:\n{res}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60 if len(got) == world else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [got[r] for r in range(world)]


def mesh_phases(torch, model, np_params, served) -> dict:
    """Model E served and trained on meshes of ranks that share the one
    card over gloo (worlds of 2 and 4; ``MESH_WORLDS``, ``MESH_TRAIN``),
    each layout held to the single-device Engine or Trainer on the same
    params and batches.  Returns each kernel's launches per rank (a
    predict, a training step) and X1's and X1b's mesh-role records."""
    import shutil
    import tempfile

    import numpy as np

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.runtime.host_prep import prepare_batch

    free_engines()
    x1_mesh_edges(torch)
    t = time.perf_counter()
    eng = Engine(model, EngineConfig(), params=np_params)
    batches = {512: served["batch_small"], 2048: served["batch_big"]}
    refs = {bs: eng.predict(b, return_pooled=True)
            for bs, b in batches.items()}
    # updates on rows the 512 batch reads: a row of the striped 2^23-row
    # group and one of a string-list group (split by columns in the main
    # layout), each to new values
    prep = prepare_batch(eng.compiled, batches[512])
    rng = np.random.default_rng(7)
    updates = []
    for name in ("emb_large_sparse0", "emb_sparse0"):
        (gi, g), = [(i, g) for i, g in enumerate(eng.compiled.groups)
                    if any(m.table == name for m in g.members)]
        col = [i for i, m in enumerate(g.members) if m.table == name][0]
        hids = prep.arrays["groups"][gi]["host_ids"][col]
        ids_u = np.unique(hids[hids >= 0])[:16]
        updates.append((name, ids_u, rng.standard_normal(
            (len(ids_u), g.dim)).astype(np.float32)))
    for name, ids_u, vals in updates:
        eng.update_table_rows(name, ids_u, vals)
    refs["updated"] = eng.predict(batches[512], return_pooled=True)
    refs["updates"] = updates
    del eng
    free_engines()
    x1b_mesh_edges(torch)
    t_ref = time.perf_counter()
    tref = mesh_train_refs(torch, model, np_params, batches[2048])
    log(f"mesh training references (the single-device card Trainer, "
        f"{MESH_TRAIN_STEPS} steps at 2048, peak {tref['peak_gib']:.2f} GiB):"
        f" {time.perf_counter() - t_ref:.1f} s; losses {tref['losses']}")
    path = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        save_mesh_inputs(np_params, batches, refs, path)
        import os
        import pickle

        with open(os.path.join(path, "train.pkl"), "wb") as f:
            pickle.dump(tref, f)
        log(f"mesh inputs (single-device references, params as .npy): "
            f"{time.perf_counter() - t:.1f} s")
        results = {}
        for world in sorted(MESH_WORLDS):
            t = time.perf_counter()
            results[world] = run_mesh_world(world, path, mesh_rank_work)
            log(f"mesh world of {world} ranks on one card (gloo): "
                f"{time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    card = card_line()
    launches = {}
    for world, ranks in results.items():
        for label, shape, cfg, gate in MESH_WORLDS[world]:
            for r, res in enumerate(ranks):
                rec = res["layouts"][label]
                log(f"mesh {label} {shape}, rank {r}/{world}: build "
                    f"{rec['build_s']:.1f} s, {rec['memory_gib']:.2f} GiB on "
                    f"the card; pooled {gate} the single-device Engine's, "
                    f"output {rec['output_512']} / {rec['output_2048']} at "
                    f"512 / 2048; launches {rec['launches_2048']} a predict")
                for bs in (512, 2048):
                    log(f"  batch {bs}: device forward "
                        f"{rec[f'forward_ms_{bs}']:.3f} ms (CUDA events, "
                        "host-paced; gloo through the host on one shared "
                        f"card, {card}); collectives p50 ms (host clock): "
                        + ", ".join(f"{k} {v}" for k, v in sorted(
                            rec[f"collectives_{bs}"].items())))
                for kid in KERNEL_META:
                    launches.setdefault(kid, {}).setdefault(
                        f"{label} {shape[0]}x{shape[1]}", []).append(
                        rec["launches_2048"].get(kid, 0))
    main = results[2]
    for r, res in enumerate(main):
        log(f"mesh main layout, rank {r}: exchange at 2048 {res['exchange']}; "
            f"overflow at capacity 0.01: {res['overflow']}; updates "
            f"{res['updates']} read back through predict and export_params")
    train_launches = {}
    for world, ranks in results.items():
        for label, shape, cfg, gate in MESH_TRAIN[world]:
            for r, res in enumerate(ranks):
                rec = res["train"][label]
                log(f"mesh {label} {shape}, rank {r}/{world}: build "
                    f"{rec['build_s']:.1f} s, peak {rec['peak_gib']:.2f} GiB;"
                    f" step 1 loss {rec['loss1']} the single device's, "
                    f"gradients held ({rec['grads']}); losses "
                    f"{rec['losses']} within rtol 1e-5; params after "
                    f"{MESH_TRAIN_STEPS} steps held ({rec['params']}); "
                    f"launches {rec['launches']} a step")
                log("  step p50 ms (host clock, synchronized; gloo through "
                    f"the host on one shared card, {card}): "
                    + ", ".join(f"{k} {v:.3f}"
                                for k, v in rec["step_ms"].items())
                    + "; collectives p50 ms: "
                    + ", ".join(f"{k} {v}" for k, v in sorted(
                        rec["collectives"].items())))
                for kid in KERNEL_META:
                    train_launches.setdefault(kid, {}).setdefault(
                        f"{label} {shape[0]}x{shape[1]}", []).append(
                        rec["launches"].get(kid, 0))
        log(f"mesh world of {world}: tools and entry "
            f"({ranks[0]['extras_s']:.1f} s): "
            + json.dumps(ranks[0]["extras"], default=str))
    x1b_roles = results[2][0]["train"][MESH_TRAIN[2][0][0]]["x1b_roles"]
    log(f"mesh phases: every layout held to the single-device Engine and "
        f"Trainer; these are gloo-on-one-card times ({card}), no yardstick "
        "for NCCL over NVLink")
    return {"launches": launches, "x1_roles": main[0]["x1_roles"],
            "train_launches": train_launches, "x1b_roles": x1b_roles}


# ---------------------------------------------------------------------------
# Random models on the card (ROADMAP item 17): the generator of
# tests/test_fuzz.py, the port's own copy, at its widths and the card's
# ---------------------------------------------------------------------------

FUZZ_KINDS = ("bucketize", "bucketize_suffix", "int_hash", "str_hash",
              "int_list", "weighted", "vocab", "weighted_str", "delim_split")
# tests/test_fuzz.py's widths: dims, vocab regimes [lo, hi), list lengths
JAX_DIMS = (4, 8)
JAX_VOCABS = ((8, 200), (500, 3000))
# the card's: the variants' edge dims, a vocab regime past
# onehot_vocab_limit (4096: such columns take X1's one-id and bag tiles),
# list lengths up to 128 (each list column draws its longest row), and
# batches at the tile edges under the default batch_buckets
CARD_DIMS = VARIANT_EDGE_D + (4, 16)
CARD_VOCABS = JAX_VOCABS + ((4097, 70_000),)
CARD_LIST_LENS = (5,) + VARIANT_EDGE_L
CARD_BATCHES = (1, 5, 31, 33, 100, 511, 513, 1500, 2047, 2048)


def random_model(rng, n_cols: int, dims=JAX_DIMS, vocabs=JAX_VOCABS):
    """A random ModelSpec of ``recom_tpu_torch.ir.spec``: mixed sources,
    transform chains, combiners, weighted lookups and post ops.

    A copy of tests/test_fuzz.py:35 ``random_model``; at its widths (the
    defaults) it draws from ``rng`` exactly as the source does, so one seed
    gives the same model.  ``dims`` and ``vocabs`` (one ``[lo, hi)`` range a
    regime) widen it for the card."""
    import dataclasses

    import numpy as np

    from recom_tpu_torch.ir import spec as S
    from recom_tpu_torch.ir.intervals import IntervalSet

    tables = {}
    cols = []
    for i in range(n_cols):
        dim = int(rng.choice(list(dims)))
        kind = rng.choice(list(FUZZ_KINDS))
        vocab = int(rng.choice([rng.integers(lo, hi) for lo, hi in vocabs]))
        tname = f"t{i}"
        tables[tname] = S.TableSpec(tname, vocab, dim, init_seed=i)
        comb = S.Combiner(list(S.Combiner)[int(rng.integers(0,
                                                            len(S.Combiner)))])
        field = f"f{i}"
        if kind == "bucketize":
            bounds = sorted(set(
                np.float32(b) for b in
                rng.uniform(-50, 50, int(rng.integers(1, vocab)))
            ))
            col = S.FeatureColumn(
                f"c{i}", S.FeatureSource(field, S.FeatureKind.DENSE_FLOAT),
                (S.Bucketize(list(bounds)),), S.LookupSpec(tname, comb),
            )
        elif kind == "bucketize_suffix":
            k = int(rng.integers(1, min(vocab - 1, 20)))
            bounds = sorted(set(np.float32(b)
                                for b in rng.uniform(-50, 50, k)))
            suffix = []
            if rng.random() < 0.5:
                lo = int(rng.integers(0, k))
                suffix.append(S.FilterRange(
                    IntervalSet.closed(lo, int(rng.integers(lo, k + 1)))))
            if rng.random() < 0.5:
                lo = int(rng.integers(0, k))
                suffix.append(S.SelectRange(
                    IntervalSet.closed(lo, int(rng.integers(lo, k + 1))),
                    int(rng.integers(0, vocab)),
                ))
            if rng.random() < 0.5:
                suffix.append(S.Mod(int(rng.integers(1, vocab))))
            col = S.FeatureColumn(
                f"c{i}", S.FeatureSource(field, S.FeatureKind.DENSE_FLOAT),
                tuple([S.Bucketize(list(bounds))] + suffix),
                S.LookupSpec(tname, comb),
            )
        elif kind == "int_hash":
            col = S.FeatureColumn(
                f"c{i}", S.FeatureSource(field, S.FeatureKind.DENSE_INT),
                (S.HashBucket(vocab),), S.LookupSpec(tname, comb),
            )
        elif kind == "str_hash":
            col = S.FeatureColumn(
                f"c{i}", S.FeatureSource(field, S.FeatureKind.STRING),
                (S.HashBucket(vocab),), S.LookupSpec(tname, comb),
            )
        elif kind == "int_list":
            col = S.FeatureColumn(
                f"c{i}", S.FeatureSource(field, S.FeatureKind.INT_LIST),
                (S.NumToId(vocab),), S.LookupSpec(tname, comb),
            )
        elif kind == "weighted":
            col = S.FeatureColumn(
                f"c{i}", S.FeatureSource(field, S.FeatureKind.INT_LIST),
                (S.NumToId(vocab),),
                S.LookupSpec(tname, comb, weight_field=f"w{i}"),
            )
        elif kind == "vocab":
            n_words = int(rng.integers(2, min(vocab, 12)))
            words = [f"w{j}" for j in range(n_words)]
            num_oov = int(rng.integers(0, vocab - n_words + 1))
            default = (
                int(rng.integers(0, n_words))
                if num_oov == 0 and rng.random() < 0.5 else -1
            )
            col = S.FeatureColumn(
                f"c{i}", S.FeatureSource(field, S.FeatureKind.STRING),
                (S.VocabLookup(words, num_oov=num_oov, default=default),),
                S.LookupSpec(tname, comb),
            )
        elif kind == "weighted_str":
            col = S.FeatureColumn(
                f"c{i}", S.FeatureSource(field, S.FeatureKind.STRING),
                (S.HashBucket(vocab),),
                S.LookupSpec(tname, comb, weight_field=f"w{i}"),
            )
        else:  # delimited split, sometimes on a two-byte delimiter
            delim = ";" if rng.random() < 0.7 else "||"
            col = S.FeatureColumn(
                f"c{i}", S.FeatureSource(field, S.FeatureKind.STRING_LIST,
                                         delimiter=delim),
                (S.HashBucket(vocab),), S.LookupSpec(tname, comb),
            )
        # post-lookup ops on a quarter of the columns
        if rng.random() < 0.25:
            post = []
            if rng.random() < 0.5:
                post.append(S.PostPool(
                    "affine",
                    scale=tuple(rng.uniform(0.5, 2.0, dim).astype(float)),
                    bias=(float(rng.uniform(-1, 1)),),
                ))
            if rng.random() < 0.3:
                post.append(S.PostPool("softmax"))
            if rng.random() < 0.3:
                cands = [c.name for c in cols if c.lookup is not None
                         and tables[c.lookup.table].dim == dim]
                if cands:
                    post.append(S.PostPool(
                        "mul_column",
                        other=cands[int(rng.integers(len(cands)))],
                    ))
            if rng.random() < 0.3:
                k = int(rng.integers(1, dim + 1))
                post.append(S.PostPool(
                    "matmul",
                    weight=tuple(tuple(rng.uniform(-1, 1, k).astype(float))
                                 for _ in range(dim)),
                ))
            if rng.random() < 0.5:
                post.append(S.PostPool(
                    "reduce_sum" if rng.random() < 0.5 else "reduce_mean"))
            if post:
                col = dataclasses.replace(col, post=tuple(post))
        cols.append(col)
    tower = S.TowerSpec(arch="mlp", bottom_mlp=(), top_mlp=(8, 1),
                        final_activation="sigmoid")
    return S.ModelSpec("fuzz", tables, cols, tower)


def random_batch(rng, model, batch: int, list_lens=None):
    """A raw batch of ``batch`` rows for ``model``: dense floats over the
    bucketize ranges, ints with 10% missing (-1), strings with vocab words
    and OOV ones, delimited strings, int lists and their weights.

    A copy of tests/test_fuzz.py:189 ``random_batch``; with ``list_lens``
    None it draws from ``rng`` exactly as the source does (rows of 0-5
    items).  ``list_lens``: each list column first draws its longest row
    from it, then each row's length in [0, longest]."""
    import numpy as np

    from recom_tpu_torch.ir.spec import FeatureKind

    def length_hi():
        return 6 if list_lens is None else int(rng.choice(list_lens)) + 1

    out = {}
    for col in model.columns:
        f = col.source.field
        kind = col.source.kind
        if kind == FeatureKind.DENSE_FLOAT:
            out[f] = rng.uniform(-80, 80, batch)
        elif kind == FeatureKind.DENSE_INT:
            vals = rng.integers(-(10**9), 10**9, batch)
            vals[rng.random(batch) < 0.1] = -1
            out[f] = vals
        elif kind == FeatureKind.STRING:
            if col.transforms and \
                    type(col.transforms[0]).__name__ == "VocabLookup":
                pool = list(col.transforms[0].vocab) + ["oovA", "oovB",
                                                        "zzz"]
                out[f] = np.asarray([pool[int(rng.integers(0, len(pool)))]
                                     for _ in range(batch)])
            else:
                out[f] = np.asarray(
                    ["s%d" % v for v in rng.integers(0, 10**6, batch)])
            if col.lookup.weight_field:
                out[col.lookup.weight_field] = rng.uniform(
                    0.1, 2.0, batch).astype(np.float32)
        elif kind == FeatureKind.STRING_LIST:
            d = col.source.delimiter
            hi = length_hi()
            out[f] = np.asarray(
                [d.join("t%d" % v for v in rng.integers(
                    0, 10**5, int(rng.integers(0, hi))))
                 for _ in range(batch)],
                dtype="S",
            )
        elif kind == FeatureKind.INT_LIST:
            vocab = model.tables[col.lookup.table].vocab_size
            hi = length_hi()
            rows = [list(rng.integers(0, vocab, int(rng.integers(0, hi))))
                    for _ in range(batch)]
            out[f] = rows
            if col.lookup.weight_field:
                out[col.lookup.weight_field] = [
                    list(rng.random(len(r)).astype(np.float32)) for r in rows
                ]
    return out


def random_config(rng, card: bool = False, mesh_shapes=None) -> dict:
    """``EngineConfig`` keyword arguments drawn over the axes of
    tests/test_fuzz_config.py:34 ``random_config`` (``use_pallas``,
    ``batch_buckets``, ``rowlen_buckets``, ``table_dtype``, ``wire_pack``,
    ``host_bucketize``, ``dedup_subcolumns``), plus ``device_hash``.
    ``card``: the default ``batch_buckets`` (batches up to 2048; the draw
    is made and dropped).  ``mesh_shapes``: also a mesh shape drawn from
    them, with ``shard_comm`` and ``shard_rows_above`` (64: most groups
    striped, or 2^22: none)."""
    mesh = None
    if mesh_shapes:
        mesh = tuple(mesh_shapes[int(rng.integers(len(mesh_shapes)))])
    dtype = ("float32", "float32", "bfloat16", "int8")[int(rng.integers(4))]
    kw = dict(
        table_dtype=dtype,
        use_pallas=bool(rng.integers(2)),
        batch_buckets=((64,), (8, 64))[int(rng.integers(2))],
        rowlen_buckets=(
            (1, 2, 4, 8, 12, 16, 32, 64, 128),
            (1, 4, 16, 64, 128),
            (128,),
        )[int(rng.integers(3))],
        wire_pack=bool(rng.integers(2)),
        host_bucketize=bool(rng.integers(2)),
        dedup_subcolumns=bool(rng.integers(2)),
        device_hash=bool(rng.integers(2)),
    )
    if card:
        del kw["batch_buckets"]
    if mesh is not None:
        kw.update(mesh_shape=mesh,
                  shard_comm=("all_to_all", "psum")[int(rng.integers(2))],
                  shard_rows_above=int(rng.choice([64, 1 << 22])))
    return kw


# fuzz_phases' seeds: FUZZ_SEED_BASE + 0 .. FUZZ_SEEDS - 1, each a random
# model at the card's widths (3-9 columns) under a random config; the even
# seeds with f32 tables also train a step
FUZZ_SEED_BASE = 14_000_000
FUZZ_SEEDS = 48


def fuzz_case(seed: int):
    """(model, config kwargs, batch, labels) of card seed ``seed``."""
    import numpy as np

    rng = np.random.default_rng(FUZZ_SEED_BASE + seed)
    model = random_model(rng, int(rng.integers(3, 10)), CARD_DIMS,
                         CARD_VOCABS)
    cfg = random_config(rng, card=True)
    bs = int(rng.choice(CARD_BATCHES))
    batch = random_batch(rng, model, bs, CARD_LIST_LENS)
    labels = rng.integers(0, 2, bs).astype(np.float32)
    return model, cfg, batch, labels


def fuzz_trains(seed: int, cfg: dict) -> bool:
    """Whether card seed ``seed`` also trains a step: every other seed,
    with f32 tables (the JAX Trainer's)."""
    return seed % 2 == 0 and cfg.get("table_dtype", "float32") == "float32"


def fuzz_launches(compiled, cfg, prep, train: bool = False) -> dict:
    """The launches of each kernel that one forward of the compiled plan
    ``compiled`` under the config ``cfg`` implies for the prepared batch
    ``prep`` (``train``: and its backward), worked out from the plan and
    the config alone, independently of the Engine's own dispatch:

    * striped: on a mesh whose model axis is over 1, each group of more
      than ``cfg.shard_rows_above`` rows (it takes the gather layout);
    * a one-hot group (``g.pallas_vocab``, not striped): K2 where all its
      columns bucketize (``g.n_bucketize == g.num_columns``), it has no
      id LUT (``g.lut_matrix``) and its raw floats reach the device (the
      structured arrays, or the wire, which one device takes under
      ``wire_pack``, with ``host_bucketize=False``), else K1, once for up
      to 16 K1 groups (``K1_MAX_GROUPS``; a group whose bucketize members
      reach the device raw is searched in that launch); the bf16 variants
      for bf16 tables; backward K3b a group, and K3a once for up to 16 of
      the K1 groups (``K3_MAX_GROUPS``);
    * X1 once for every other gather group together (X1-bf16, X1-int8 by
      the stored dtype; on a mesh with the psum path's partial sums), and
      once more (X1: the rows return as f32) to pool the rows the
      all-to-all exchange returned for the striped groups; backward (one
      device) X1b once; each launch takes up to 8 groups
      (``X1_MAX_GROUPS``, ``X1B_MAX_GROUPS``);
    * Part (the partition), in the forward of a training step, once for
      up to 16 of the step's listed groups (``PART_MAX_GROUPS``): each
      X1b group, each K3a group and each K3b group cut into several vocab
      tiles (``k3_listed``);
    * X2 once for each group whose strings the card hashes: the wire's
      ``prep.wsig``, which the batch's string widths decide."""
    from recom_tpu_torch.ops.lookup_gather import (
        X1_MAX_GROUPS,
        X1B_MAX_GROUPS,
    )
    from recom_tpu_torch.ops.item_lists import PART_MAX_GROUPS
    from recom_tpu_torch.ops.lookup_onehot import (
        K1_MAX_GROUPS,
        K3_MAX_GROUPS,
        k3_listed,
    )

    sfx = {"float32": "", "bfloat16": "-bf16", "int8": "-int8"}[
        cfg.table_dtype]
    mesh = cfg.mesh_shape is not None
    require(not (train and mesh),
            "fuzz_launches: training launches are counted on one device")
    model_ranks = cfg.mesh_shape[1] if mesh else 1
    wire = bool(cfg.wire_pack) and not mesh
    raw = not (wire and cfg.host_bucketize)
    exchange = mesh and cfg.shard_comm == "all_to_all"

    def launches(groups: int, per: int) -> int:
        return -(-groups // per)

    n = dict.fromkeys(KERNEL_META, 0)
    gather = routed = k1 = 0
    listed = 0              # the step's groups whose entries Part lists
    for g in compiled.groups:
        striped = model_ranks > 1 and g.stacked_rows > cfg.shard_rows_above
        if g.pallas_vocab is not None and not striped:
            fused = (raw and g.n_bucketize == g.num_columns
                     and g.lut_matrix is None)
            n["K2" + sfx] += fused
            k1 += not fused
            listed += k3_listed(g.pallas_vocab, g.dim)
            n["K3b"] += fused and train
        elif striped and exchange:
            routed += 1
        else:
            gather += 1
    if k1:
        n["K1" + sfx] = launches(k1, K1_MAX_GROUPS)
    n["X1" + sfx] = launches(gather, X1_MAX_GROUPS)
    # the exchange returns rows as f32 (gather_rows_f32 on the owner)
    n["X1"] += launches(routed, X1_MAX_GROUPS)
    if train:
        n["K3a"] = launches(k1, K3_MAX_GROUPS)
        n["X1b"] = launches(gather, X1B_MAX_GROUPS)
        n["Part"] = launches(listed + gather, PART_MAX_GROUPS)
    n["X2"] = sum(1 for w in prep.wsig if any(w)) if wire else 0
    return n


def fuzz_context(seed: int, model, cfg: dict, bs: int) -> str:
    """A seed's config and model, for a failure's message."""
    kinds = ", ".join(
        f"{c.name}:{c.source.kind.name}/{model.tables[c.lookup.table].vocab_size}"
        f"x{model.tables[c.lookup.table].dim}" for c in model.columns)
    return f"fuzz seed {seed} (batch {bs}; config {cfg}; columns {kinds})"


def fuzz_gates(out, ref, model, ctx: str, exact: bool = True) -> None:
    """run_config_seed's gates (tests/test_fuzz_config.py:63): each pooled
    column ``==`` the oracle (within rtol / atol 1e-6 where ``exact`` is
    False: the psum path); the concat ``==``, or within 1e-6 with post ops
    or off ``exact``.  A failure names the first column and element that
    differ."""
    import numpy as np

    def check(got, want, tight: bool, what: str) -> None:
        require(got.shape == want.shape, f"{ctx}: {what}'s shape "
                f"{got.shape} != the oracle's {want.shape}")
        bad = (got != want) if tight else ~np.isclose(got, want, rtol=1e-6,
                                                      atol=1e-6)
        if bad.any():
            at = tuple(int(i) for i in np.argwhere(bad)[0])
            raise RuntimeError(
                f"chip_smoke: {ctx}: {what} differs from the oracle "
                f"({'==' if tight else 'rtol / atol 1e-6'}), first at {at}: "
                f"{got[at]!r} vs {want[at]!r}")

    require(set(out["pooled"]) == set(ref["pooled"]), f"{ctx}: columns")
    for c, r in ref["pooled"].items():
        check(out["pooled"][c], r, exact, f"pooled column {c}")
    check(out["concat"], ref["concat"],
          exact and not any(c.post for c in model.columns), "the concat")


def fuzz_seed(torch, seed: int, device: str = "cuda",
              oracle=None) -> dict:
    """Card seed ``seed`` (``fuzz_case``) served, and on even f32 seeds
    trained a step, on ``device``:

    * ``predict`` with the pooled outputs and the concat, held by
      ``fuzz_gates`` to ``oracle(model, params, batch)`` (by default the
      port's ``OracleModel(model, params).forward(batch)``; bf16 / int8:
      on the engine's own ``export_params``,
      tests/test_fuzz_config.py:11-15),
      and its output within rtol 1e-4 / atol 1e-5 of the same Engine
      rebuilt on the CPU from the same params (every kernel's plain
      version);
    * on the card, each kernel's launches in that ``predict`` exactly
      ``fuzz_launches``'; and in the training step, after the staged
      check of ``grads_close`` against the same step on CPU copies, the
      forward's and the backward's.

    Returns the seed's record: its config, batch, launch counts (the
    expected ones off the card), the largest output difference from the
    CPU and, where it trained, the step's counts and loss."""
    import numpy as np

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.oracle import OracleModel
    from recom_tpu_torch.runtime.checkpoint import export_params
    from recom_tpu_torch.runtime.executor import Engine
    from recom_tpu_torch.train import Trainer, dlrm_optimizer
    from recom_tpu_torch.utils.params import init_model_params

    model, kw, batch, labels = fuzz_case(seed)
    bs = len(labels)
    ctx = fuzz_context(seed, model, kw, bs)
    on_card = torch.device(device).type == "cuda"
    cfg = EngineConfig(**kw)
    params = init_model_params(model)

    def counted(fn, want, what):
        kernels.reset_launches()
        res = fn()
        if not on_card:
            return res, want
        torch.cuda.synchronize()
        got = dict(kernels.launches)
        bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        require(not bad, f"{ctx}: {what} launches (got, expected): {bad}")
        return res, got

    eng = Engine(model, cfg, params=params, device=device)
    out, counts = counted(
        lambda: eng.predict(batch, return_pooled=True, return_concat=True),
        fuzz_launches(eng.compiled, cfg, eng.prepare(batch)), "predict")
    oparams = (export_params(eng) if cfg.table_dtype != "float32"
               else params)
    del eng
    if oracle is None:
        ref = OracleModel(model, oparams).forward(batch)
    else:
        ref = oracle(model, oparams, batch)
    fuzz_gates(out, ref, model, ctx)
    cpu = Engine(model, cfg, params=params, device="cpu").predict(batch)
    require(bool(np.isfinite(out["output"]).all())
            and out["output"].shape == (bs, 1), f"{ctx}: output")
    require(np.allclose(out["output"], cpu["output"], rtol=1e-4, atol=1e-5),
            f"{ctx}: output differs from the CPU Engine's past rtol 1e-4 / "
            "atol 1e-5")
    rec = {"seed": seed, "batch": bs, "config": kw, "launches": counts,
           "err": float(np.abs(out["output"] - cpu["output"]).max())}
    if fuzz_trains(seed, kw):
        card = Trainer(model, cfg, optimizer=dlrm_optimizer(), params=params,
                       device=device)
        cpu_tr = Trainer(model, cfg, optimizer=dlrm_optimizer(),
                         params=params, device="cpu")
        grads_close(torch, card, cpu_tr, batch, labels, ctx)
        loss, rec["train_launches"] = counted(
            lambda: card.step(batch, labels),
            fuzz_launches(card.engine.compiled, cfg,
                          card.engine.prepare(batch), True),
            "training step")
        require(bool(np.isfinite(loss)), f"{ctx}: loss {loss}")
        rec["loss"] = float(loss)
    return rec


# the mesh seeds: served on a world of 2 ranks that share the card over
# gloo at (1, 2), every group over 64 rows striped, under each comm
FUZZ_MESH_SEEDS = 3
FUZZ_MESH_COMMS = ("psum", "all_to_all")


def fuzz_mesh_case(seed: int):
    """(model, config kwargs, batch) of mesh seed ``seed``: a card seed's
    draw (``FUZZ_SEED_BASE + 1000 + seed``) on ``mesh_shape=(1, 2)`` with
    ``shard_rows_above=64``."""
    import numpy as np

    rng = np.random.default_rng(FUZZ_SEED_BASE + 1000 + seed)
    model = random_model(rng, int(rng.integers(3, 10)), CARD_DIMS,
                         CARD_VOCABS)
    cfg = random_config(rng, card=True)
    cfg.update(mesh_shape=(1, 2), shard_rows_above=64)
    batch = random_batch(rng, model, int(rng.choice(CARD_BATCHES)),
                         CARD_LIST_LENS)
    return model, cfg, batch


def fuzz_mesh_work(torch, rank: int, world: int, path: str) -> list:
    """A rank's part of the mesh seeds: each case of ``path``'s
    ``fuzz.pkl`` served once under each of ``FUZZ_MESH_COMMS`` by an
    Engine on the (1, 2) mesh, its launches asserted (``fuzz_launches``;
    X2 none: no wire on a mesh).  Returns per case and comm the rank's
    ``predict`` result, launches and striped groups (rank 0: also the
    engine's ``export_params`` for bf16 / int8 tables)."""
    import os
    import pickle

    from recom_tpu_torch import EngineConfig
    from recom_tpu_torch.ir.serde import model_from_json
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.parallel import make_mesh
    from recom_tpu_torch.runtime.checkpoint import export_params
    from recom_tpu_torch.runtime.executor import Engine

    with open(os.path.join(path, "fuzz.pkl"), "rb") as f:
        cases = pickle.load(f)
    mesh = make_mesh((1, 2), backend="gloo", device="cuda:0")
    recs = []
    for case in cases:
        model = model_from_json(case["model"])
        for comm in FUZZ_MESH_COMMS:
            cfg = EngineConfig(**dict(case["config"], shard_comm=comm))
            eng = Engine(model, cfg, params=case["params"], mesh=mesh)
            want = fuzz_launches(eng.compiled, cfg,
                                 eng.prepare(case["batch"]))
            kernels.reset_launches()
            out = eng.predict(case["batch"], return_pooled=True,
                              return_concat=True)
            torch.cuda.synchronize()
            got = dict(kernels.launches)
            bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
            require(not bad, f"mesh fuzz seed {case['seed']} {comm}, rank "
                    f"{rank}: launches (got, expected): {bad}")
            rec = {"seed": case["seed"], "comm": comm, "out": out,
                   "launches": got,
                   "sharded": [g.gid for g in eng.compiled.groups
                               if g.stacked_rows > cfg.shard_rows_above]}
            if rank == 0 and cfg.table_dtype != "float32":
                rec["params"] = export_params(eng)
            elif cfg.table_dtype != "float32":
                export_params(eng)      # collective: every rank joins
            recs.append(rec)
            del eng
    return recs


def fuzz_mesh(torch) -> dict:
    """The mesh seeds (``fuzz_mesh_case``) on a spawned world of 2 ranks
    that share the card over gloo, held to the oracle with
    run_config_seed's gates: pooled ``==`` under the exchange, within
    1e-6 under psum (where a group is striped); the concat likewise; the
    output within rtol 1e-4 / atol 1e-5; both ranks' results ``==``.
    Returns the launch totals of rank 0 and the pairs run."""
    import os
    import pickle
    import shutil
    import tempfile

    import numpy as np

    from recom_tpu_torch.ir.serde import model_to_json
    from recom_tpu_torch.oracle import OracleModel
    from recom_tpu_torch.utils.params import init_model_params

    cases = []
    for seed in range(FUZZ_MESH_SEEDS):
        model, cfg, batch = fuzz_mesh_case(seed)
        cases.append({"seed": seed, "model": model_to_json(model),
                      "config": cfg, "batch": batch,
                      "bs": len(next(iter(batch.values()))),
                      "params": init_model_params(model), "spec": model})
    path = tempfile.mkdtemp(prefix="chip_smoke_fuzz_")
    try:
        with open(os.path.join(path, "fuzz.pkl"), "wb") as f:
            pickle.dump([{k: v for k, v in c.items() if k != "spec"}
                         for c in cases], f)
        ranks = run_mesh_world(2, path, fuzz_mesh_work)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    totals = dict.fromkeys(KERNEL_META, 0)
    for i, rec in enumerate(ranks[0]):
        case = cases[rec["seed"]]
        model, batch = case["spec"], case["batch"]
        other = ranks[1][i]
        ctx = "mesh " + fuzz_context(rec["seed"], model, case["config"],
                                     case["bs"]) + f" under {rec['comm']}"
        for c, r in rec["out"]["pooled"].items():
            require(np.array_equal(other["out"]["pooled"][c], r),
                    f"{ctx}: rank 1's pooled column {c} != rank 0's")
        ref = OracleModel(model, rec.get("params", case["params"])).forward(
            batch)
        exact = rec["comm"] == "all_to_all" or not rec["sharded"]
        fuzz_gates(rec["out"], ref, model, ctx, exact=exact)
        require(np.allclose(rec["out"]["output"], ref["output"], rtol=1e-4,
                            atol=1e-5), f"{ctx}: output")
        for k, n in rec["launches"].items():
            totals[k] += n
        log(f"  {ctx.split(' (')[0]} {rec['comm']}: batch "
            f"{len(rec['out']['output'])}, {len(rec['sharded'])} striped "
            f"group(s), pooled {'==' if exact else 'within 1e-6 of'} the "
            f"oracle; launches "
            f"{ {k: n for k, n in rec['launches'].items() if n} }")
    return {"pairs": len(ranks[0]), "launches": totals}


def fuzz_phases(torch) -> dict:
    """ROADMAP item 17 on the card: ``FUZZ_SEEDS`` random models at the
    card's widths under random single-device configs (``fuzz_seed``: the
    oracle, the CPU Engine, exact launch counts, a training step on the
    even f32 seeds), then the mesh seeds (``fuzz_mesh``).  Fails where a
    kernel of ``KERNEL_META`` never launched in the sweep.  Prints the
    ``{"fuzz": ...}`` line and returns its document."""
    t0 = time.perf_counter()
    totals = dict.fromkeys(KERNEL_META, 0)
    err, trained, axes = 0.0, 0, set()
    for seed in range(FUZZ_SEEDS):
        t = time.perf_counter()
        rec = fuzz_seed(torch, seed)
        for counts in (rec["launches"], rec.get("train_launches", {})):
            for k, n in counts.items():
                totals[k] += n
        err = max(err, rec["err"])
        trained += "loss" in rec
        cfg = rec["config"]
        axes |= {("table_dtype", cfg["table_dtype"]),
                 ("use_pallas", cfg["use_pallas"]),
                 ("dedup_subcolumns", cfg["dedup_subcolumns"])}
        if not cfg["host_bucketize"]:
            axes.add(("wire_pack, host_bucketize=False", cfg["wire_pack"]))
        launched = {k: n for k, n in rec["launches"].items() if n}
        log(f"  fuzz seed {seed}: batch {rec['batch']}, {cfg}; launches "
            f"{launched}" + (f"; trained (loss {rec['loss']:.6f}, launches "
                             f"{ {k: n for k, n in rec['train_launches'].items() if n} })"
                             if "loss" in rec else "")
            + f"; output within {rec['err']:.3g} of the CPU's "
            f"({time.perf_counter() - t:.2f} s)")
        gc.collect()
    torch.cuda.empty_cache()
    want_axes = {("table_dtype", d) for d in ("float32", "bfloat16", "int8")}
    want_axes |= {(a, v) for a in ("use_pallas", "dedup_subcolumns",
                                   "wire_pack, host_bucketize=False")
                  for v in (False, True)}
    require(want_axes <= axes, f"fuzz: config axes never drawn: "
            f"{sorted(want_axes - axes)}")
    t_mesh = time.perf_counter()
    mesh = fuzz_mesh(torch)
    mesh_s = time.perf_counter() - t_mesh
    missing = [k for k in KERNEL_META if totals[k] == 0]
    require(not missing, f"fuzz: kernels never launched in the "
            f"{FUZZ_SEEDS} seeds: {missing}")
    doc = {"seeds": FUZZ_SEEDS, "pairs": FUZZ_SEEDS, "trained": trained,
           "mesh_seeds": FUZZ_MESH_SEEDS, "mesh_pairs": mesh["pairs"],
           "launches": totals, "mesh_launches": mesh["launches"],
           "max_output_err": err, "mesh_seconds": mesh_s,
           "seconds": time.perf_counter() - t0, "card": card_line()}
    print(json.dumps({"fuzz": doc}))
    return doc


# ROADMAP item 18: each example's arguments on the card, the line its
# check prints, and the kernels its model's path launches (dlrm: model E's
# predict, twice, K1 1, X1 1, X2 3, and each of its 2 training steps those
# and K3a 1, X1b 1, Part 1)
EXAMPLES = (
    ("dlrm", ["--model", "E", "--scale", "1.0", "--batch", "2048",
              "--train-steps", "2"],
     "all pooled embedding outputs bit-exact vs oracle",
     {"K1": 4, "X1": 4, "X2": 12, "K3a": 2, "X1b": 2, "Part": 2}),
    ("microbenchmark", ["--columns", "1000", "--batch", "2048",
                        "--random-boundary"],
     "bit-exact vs oracle: 1000 columns OK", {"K1": None}),
    ("serving", [], "request 0: pooled outputs bit-exact vs oracle",
     {"K1": None, "X1": None, "X2": None}),
)


def examples_phase(torch) -> dict:
    """The three examples of ``recom_tpu_torch/examples/`` run once each on
    the card through their ``main(argv)`` (``EXAMPLES``): each must print
    its check against the oracle and launch its path's kernels and no
    other (dlrm: exactly).  Returns each one's launches and seconds."""
    import contextlib
    import importlib
    import io

    from recom_tpu_torch.ops import kernels

    done = {}
    for name, argv, check, want in EXAMPLES:
        mod = importlib.import_module(f"recom_tpu_torch.examples.{name}")
        buf = io.StringIO()
        t = time.perf_counter()
        kernels.reset_launches()
        with contextlib.redirect_stdout(buf):
            mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = dict(kernels.launches)
        lines = buf.getvalue().splitlines()
        for line in lines:
            log(f"  example {name}: {line}")
        require(check in lines, f"example {name} {argv}: no line {check!r}")
        require_launches(counts, list(want), f"example {name}",
                         exactly={k: n for k, n in want.items()
                                  if n is not None})
        counts = {k: n for k, n in counts.items() if n}
        log(f"example {name} {' '.join(argv)}: {secs:.1f} s; launches "
            f"{counts}")
        done[name] = {"launches": counts, "seconds": secs}
        gc.collect()
        torch.cuda.empty_cache()
    return done


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    from recom_tpu_torch.models import make_model_e
    from recom_tpu_torch.ops import kernels
    from recom_tpu_torch.utils.params import init_model_params

    t_start = time.perf_counter()

    def elapsed(what: str) -> None:
        log(f"[{time.perf_counter() - t_start:.0f} s] {what} done")

    card = card_line()
    int_rate = int32_ops_per_s()
    log(f"card: {card}; INT32 peak {int_rate / 1e12:.2f} Tops/s (132 SMs x "
        f"64 lanes x clocks.max.sm {nvidia_smi('clocks.max.sm')})")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # ---- phase 1: build every kernel from the checkout's sources ---------
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    t = time.perf_counter()
    paths = kernels.build_all()
    log(f"kernel build: {time.perf_counter() - t:.2f} s "
        f"({', '.join(sorted(paths))}; {nvcc})")

    # ---- the PostPool models, small, first -------------------------------
    postpool_phases(torch)
    elapsed("PostPool phases")

    # ---- random models through every kernel (served, trained, on a mesh) --
    fuzz = fuzz_phases(torch)
    elapsed("fuzz phases")

    # ---- full-size model E on the card ------------------------------------
    t = time.perf_counter()
    model = make_model_e(seed=0)
    np_params = init_model_params(model)
    log(f"model E params on host: {time.perf_counter() - t:.1f} s")
    served = serve_phases(torch, model, np_params, int_rate)
    elapsed("serving phases")
    free_engines()
    log(f"serving engines freed: {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB left on the card")

    # ---- model E imported from its GraphDef; bf16 and int8 tables ---------
    imported_phase(torch, model, np_params, served)
    stored = stored_phases(torch, model, np_params, served)
    variant_edges(torch)
    elapsed("imported and stored-dtype phases")
    log(f"stored-dtype engines freed: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB left on the card")

    # ---- the serving runtime and the parameter lifecycle --------------------
    runtime = runtime_phases(torch, model, np_params, served)
    elapsed("serving-runtime phases")

    # ---- model E on meshes of ranks that share the card -------------------
    mesh = mesh_phases(torch, model, np_params, served)
    elapsed("mesh phases")
    trained = train_phases(torch, model, np_params, served["batch_small"],
                           served["batch_big"], served["ref"])
    print_json("training programs (model E, bucketize-880)", {
        k: trained[k] for k in ("gate_e", "times_e", "gate_bz", "times_bz",
                                "gate_searched")})
    elapsed("training phases")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the Criteo DLRM at full width -------------------------------------
    criteo = criteo_phases(torch)
    print_json("training programs (Criteo DLRM)", criteo.pop("training"))
    elapsed("Criteo phases")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the measurement tools and entry points; model F -------------------
    from recom_tpu_torch.models import make_random_batch

    base = [served["batch_big"], make_random_batch(model, 2048, seed=40)]
    tools = tools_phases(torch, model, np_params, base)
    elapsed("tools phases")
    del model, np_params, base
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the examples, dlrm at model E's full width -------------------------
    examples = examples_phase(torch)
    elapsed("examples")
    results = {**served["results"], **trained["results"], **stored}
    launches = {
        "K1": served["counts_2048"]["K1"], "K2": served["counts_mb"]["K2"],
        "X1": served["counts_2048"]["X1"], "X2": served["counts_2048"]["X2"],
        "K3a": trained["counts_train"]["K3a"],
        "K3b": trained["counts_bz"]["K3b"],
        "X1b": trained["counts_train"]["X1b"],
        "Part": trained["counts_train"]["Part"],
        **{kid: r["launches"] for kid, r in stored.items()},
    }

    def entry(r, n):
        return {
            "launches": n, "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "cold_ms": r["cold_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["lib"], "share": r["bound_ms"] / r["ms"],
            **({"classes": r["classes"]} if "classes" in r else {}),
            **({"oneid_f32_ab": r["oneid_f32_ab"]}
               if "oneid_f32_ab" in r else {}),
        }

    # each kernel's launches in the serving-runtime phases: the pipeline's
    # 24 requests, the predict after each dtype's updates, and the Trainer
    # step after reload_params
    runtime_launches = {}
    for counts in runtime.values():
        for kid, n in counts.items():
            if n:
                runtime_launches.setdefault(kid, []).append(n)

    line = {"kernels": [
        {
            "name": kid, "route": "cuda",
            "source": KERNEL_META[kid][0], "replaces": KERNEL_META[kid][1],
            **entry(results[kid], launches[kid]),
            "runtime_launches": runtime_launches.get(kid, []),
            # the random models' sweep (fuzz_phases): single device, all
            # seeds, serving and training
            "fuzz_launches": fuzz["launches"][kid],
            "examples_launches": {name: e["launches"].get(kid, 0)
                                  for name, e in examples.items()},
            # the same kernel on the Criteo DLRM's path (d = 64)
            **({"criteo": entry(criteo[kid], criteo[kid]["launches"])}
               if kid in criteo else {}),
            # K1 with model E's bucketize members searched in its id read
            # (host_bucketize=False, batch 2048)
            **({"searched": dict(
                entry(served["searched"], served["searched"]["launches"]),
                reference_ms=served["searched"]["reference_ms"])}
               if kid == "K1" else {}),
            # on model F's path at batch 2048
            **({"model_f": entry(tools["f_results"][kid],
                                 tools["f_counts"][kid])}
               if kid in tools["f_results"] else {}),
            # X1 alone at ragged_bench's rungs L = 16, 32, 64, 128
            **({"ragged": tools["ragged"]} if kid == "X1" else {}),
            # model E on the mesh layouts: launches of one predict at 2048
            # on each rank, and X1's mesh roles (psum partial, a2a pool)
            "mesh": {"launches_per_rank": mesh["launches"][kid],
                     "train_launches_per_rank": mesh["train_launches"][kid],
                     **({"roles": mesh["x1_roles"]} if kid == "X1"
                        else {}),
                     **({"train_roles": mesh["x1b_roles"]} if kid == "X1b"
                        else {})},
        }
        for kid in KERNEL_META
    ]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

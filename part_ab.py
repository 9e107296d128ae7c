#!/usr/bin/env python3
"""Part (the partition pass, ``recom_tpu_torch/csrc/partition.cu``) and
the backward kernels that read its lists, K3a and X1b, of two checkouts,
timed on the same inputs at the same segment size.

Run from a checkout's root on a machine with an NVIDIA GPU:

    python3 part_ab.py OTHER [--seg 2048] [--other-seg N] [--rounds 2]

OTHER is a directory that holds another checkout's ``recom_tpu_torch/``
(for instance a parent commit's ``git archive``, unpacked).  The script

1. makes the inputs of the training step's backward kernels in this
   checkout, as ``chip_smoke.backward_calls`` makes them: model E in the
   default ``EngineConfig`` and the Criteo DLRM, both full width, random
   weights from seed 0, a batch of 2048: the entries of the step's one
   launch of Part, and K3a's and X1b's arguments with random cotangents;
   and two members with far more items than entries (4096 items over 256
   and over 2048 entries a column), where a block whose work follows its
   member's items, not its entries, pays most;
2. copies both checkouts' ``recom_tpu_torch/`` into a temporary directory
   with the segment size set to SEG in each (``csrc/item_lists.cuh``'s
   ``kSeg``, ``ops/item_lists.py``'s ``PART_SEG``; both are left as they
   are where SEG is 0), OTHER's to N where ``--other-seg`` is given (OTHER
   may be this checkout: one segment size against another);
3. times, in each copy, ``item_lists.partition`` on those entries, and
   ``onehot_lookups_grad`` and ``groups_pooled_grad`` called with no
   lists (so each lists its own: one launch of Part, then the kernel, in
   either checkout), in turns (OTHER, this, this, OTHER, a round), each
   turn a process of its own that first holds Part ``==`` its plain
   version and K3a and X1b within 1e-3 of theirs (the card's plain
   versions add with atomics).

Times are CUDA events around 50 back-to-back calls queued behind a sleep
kernel (the card's time, not the host's dispatch), per call.  The first
line is the card's name and power limit; each turn prints one ``RESULT``
line, a JSON object of its readings in ms; the last line is one JSON
object of every turn's readings, with each case's mean per checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

MODELS = ("model E", "Criteo")
CASES = tuple(f"{kind} {m}" for m in MODELS
              for kind in ("Part", "K3a with its Part", "X1b with its Part")
              ) + ("Part items >> entries",)
ITERS = 50
SLEEP_CYCLES = 100_000_000


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def step_entries(torch) -> dict:
    """{case: [partition entry, ...]} on the CPU: the step's Part entries
    of model E and of the Criteo DLRM (``chip_smoke.backward_calls``'
    ``Part`` record) and the many-items members."""
    import numpy as np

    import chip_smoke
    from recom_tpu_torch import Engine, EngineConfig
    from recom_tpu_torch.models import (
        make_criteo_dlrm,
        make_model_e,
        make_random_batch,
    )
    from recom_tpu_torch.ops.item_lists import member_info
    from recom_tpu_torch.runtime.wire import unpack_blob
    from recom_tpu_torch.utils.params import init_model_params

    rng = np.random.default_rng(7)

    def cotangent(bp, c, d):
        return torch.from_numpy(
            rng.standard_normal((bp, c, d), dtype=np.float32)).to("cuda")

    cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
    out = {}
    for case, model, batch in (
            ("model E", make_model_e(seed=0),
             lambda m: make_random_batch(m, 2048, seed=1)),
            ("Criteo", make_criteo_dlrm(seed=0),
             lambda m: chip_smoke.criteo_batch(m, 2048, seed=1))):
        eng = Engine(model, EngineConfig(), params=init_model_params(model),
                     device="cuda")
        with torch.no_grad():
            prep = eng.prepare(batch(model))
            arrays = unpack_blob(eng.compiled, eng.to_device(prep)["blob"],
                                 prep.batch_padded, prep.rowlens, prep.wsig)
            recs = chip_smoke.backward_calls(torch, eng, arrays,
                                             prep.batch_padded, cotangent)
        out[f"Part {case}"] = [{k: cpu(v) for k, v in g.items()}
                               for g in recs["Part"][0]["groups"]]
        for kid in ("K3a", "X1b"):
            out[f"{kid} with its Part {case}"] = [
                tuple(cpu(x) for x in a) for a in recs[kid][0]["args"]]
        del eng, recs, arrays
        torch.cuda.empty_cache()
    many = []
    for c, s in ((8, 256), (8, 2048)):
        ids = rng.integers(-1, 4096, (c, s)).astype(np.int32)
        many.append(dict(ids=torch.from_numpy(ids),
                         caps=torch.full((c,), 4095, dtype=torch.int32),
                         info=member_info(np.ones(c), np.full(c, 4096),
                                          np.full(c, 4096))))
    out["Part items >> entries"] = many
    return out


def set_segment(root: str, seg: int) -> None:
    """Set a copy's segment size: ``kSeg`` in csrc/item_lists.cuh and
    ``PART_SEG`` in ops/item_lists.py."""
    for rel, pat, new in (
            ("recom_tpu_torch/csrc/item_lists.cuh",
             r"constexpr int kSeg = \d+;", f"constexpr int kSeg = {seg};"),
            ("recom_tpu_torch/ops/item_lists.py",
             r"^PART_SEG = \d+", f"PART_SEG = {seg}")):
        path = os.path.join(root, rel)
        with open(path) as f:
            text = f.read()
        text, n = re.subn(pat, new, text, count=1, flags=re.M)
        if n != 1:
            raise SystemExit(f"{rel}: no segment size to set")
        with open(path, "w") as f:
            f.write(text)


def checked(torch, case: str, inputs):
    """(the call to time, its inputs on the card), after holding the
    call's output to its plain version."""
    from recom_tpu_torch.ops import item_lists as il
    from recom_tpu_torch.ops import lookup_gather as tg
    from recom_tpu_torch.ops import lookup_onehot as tk

    card = lambda x: x.cuda() if isinstance(x, torch.Tensor) else x
    if case.startswith("Part"):
        groups = [{k: card(v) for k, v in g.items()} for g in inputs]
        for g, lists in zip(groups, il.partition(groups)):
            want = il.partition_plain(il.plain_values(g), g["info"])
            if not all(torch.equal(a, b) for a, b in zip(lists, want)):
                raise SystemExit(f"{case}: Part != its plain version")
        return lambda: il.partition(groups)
    groups = [tuple(card(x) for x in a) for a in inputs]
    fn, plain = ((tk.onehot_lookups_grad, tk.onehot_lookup_grad_plain)
                 if case.startswith("K3a") else
                 (tg.groups_pooled_grad, tg.group_pooled_grad_plain))
    for got, a in zip(fn(groups), groups):
        err = float((got - plain(*a)).abs().max())
        if not err <= 1e-3:
            raise SystemExit(f"{case}: {err} from its plain version")
    return lambda: fn(groups)


def time_turn(entries_file: str) -> dict:
    """This process's checkout's Part, K3a and X1b on the saved inputs:
    checked (``checked``), then timed (ms a call, on the card's clock)."""
    import torch

    from recom_tpu_torch.ops import item_lists as il

    saved = torch.load(entries_file, weights_only=False)
    got = {"PART_SEG": il.PART_SEG}
    for case in CASES:
        fn = checked(torch, case, saved[case])
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        t0.record()
        for _ in range(ITERS):
            fn()
        t1.record()
        t1.synchronize()
        got[case] = t0.elapsed_time(t1) / ITERS
        torch.cuda.empty_cache()
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--seg", type=int, default=2048)
    ap.add_argument("--other-seg", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("part_ab.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.turn:
        print("RESULT " + json.dumps(time_turn(args.turn)), flush=True)
        return 0
    if not args.other:
        ap.error("OTHER is required")
    here = os.path.dirname(os.path.abspath(__file__))
    print(card_line(), flush=True)
    # the copies under this checkout's git-ignored build directory
    build = os.path.join(here, "recom_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="part_ab_") as tmp:
        entries = os.path.join(tmp, "entries.pt")
        torch.save(step_entries(torch), entries)
        trees = {}
        for name, src in (("other", args.other), ("this", here)):
            dst = os.path.join(tmp, name)
            shutil.copytree(os.path.join(src, "recom_tpu_torch"),
                            os.path.join(dst, "recom_tpu_torch"),
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            shutil.copy(os.path.abspath(__file__), dst)
            seg = (args.other_seg if name == "other"
                   and args.other_seg is not None else args.seg)
            if seg:
                set_segment(dst, seg)
            trees[name] = dst
        readings = {"other": [], "this": []}
        for _ in range(args.rounds):
            for name in ("other", "this", "this", "other"):
                run = subprocess.run(
                    [sys.executable, "part_ab.py", "--turn", entries],
                    cwd=trees[name], capture_output=True, text=True)
                sys.stderr.write(run.stderr[-4000:])
                if run.returncode:
                    print(f"{name}: rc {run.returncode}", flush=True)
                    return 1
                line = [x for x in run.stdout.splitlines()
                        if x.startswith("RESULT ")][-1]
                print(f"{name} {line}", flush=True)
                readings[name].append(json.loads(line[len("RESULT "):]))
    mean = {name: {case: sum(r[case] for r in rs) / len(rs)
                   for case in CASES} for name, rs in readings.items()}
    print(json.dumps({"seg": args.seg, "other_seg": args.other_seg,
                      "readings": readings, "mean": mean}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

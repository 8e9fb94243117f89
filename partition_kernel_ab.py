"""Two trees' partition-id kernels on one card, in turns.

    python3 partition_kernel_ab.py --tree OLD --tree NEW [--rounds 2]

Each tree is a checkout of this repository (e.g. the parent commit from
`git archive` into the git-ignored `chip_checkout/`). Every turn is a
fresh process that imports that tree's `spark_rapids_tpu_torch`, builds
its kernel, checks `partition_ids_i32` against the tree's plain version
bit for bit at the exchange's batch shape (1,048,576 rows, 200
partitions), and times the wrapper call with CUDA events:
  - one call at a time with L2 flushed clean first (a read of 256 MB);
  - the same with L2 flushed by writing 256 MB (dirty lines left behind);
  - back to back, between one pair of events;
and the host's own cost per call (host clock over calls issued without
a synchronize). Turns run OLD NEW NEW OLD per round. Prints one JSON line
per turn, the card's `nvidia-smi` name and power limit, and a summary
line with each tree's medians; exits non-zero if any turn failed.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def turn(tree: str) -> dict:
    # this tree's timing helpers first, then the measured tree's package
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from spark_rapids_tpu_torch.ops import partition_kernels as pk
    if not os.path.abspath(pk.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {pk.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    dev = torch.device("cuda")
    vals, valid = cs.partition_keys(cs.BATCH_ROWS, seed=5)
    kv = torch.from_numpy(vals).to(dev)
    vv = torch.from_numpy(valid).to(dev)

    def call():
        return pk.partition_ids_i32(kv, vv, cs.REPARTITION_N)
    t0 = time.perf_counter()
    got = call()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ref = pk.partition_ids_i32_ref(kv, vv, cs.REPARTITION_N)
    if not torch.equal(got, ref):
        raise AssertionError(f"{tree}: kernel differs from plain version")
    return {"tree": tree, "first_call_s": first_s,
            "ms_read_flush": cs.cuda_ms(call, flush=cs.l2_flush(torch, dev)),
            "ms_zero_flush": cs.cuda_ms(
                call, flush=cs.l2_flush(torch, dev, dirty=True)),
            "back_to_back_ms": cs.back_to_back_ms(call),
            "host_us_per_call": cs.host_us_per_call(torch, call)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(args.turn)), flush=True)
        return 0
    if len(args.tree) != 2:
        ap.error("give exactly two --tree")
    old, new = args.tree
    import torch
    if not torch.cuda.is_available():
        print("partition_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    print(cs.nvidia_smi_line(), flush=True)
    results = {old: [], new: []}
    failed = 0
    for _ in range(args.rounds):
        for tree in (old, new, new, old):
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--turn", tree], capture_output=True,
                               text=True, timeout=900)
            if r.returncode != 0:
                failed += 1
                print(json.dumps({"tree": tree, "failed": r.returncode,
                                  "stderr": r.stderr[-3000:]}), flush=True)
                continue
            line = json.loads(r.stdout.strip().splitlines()[-1])
            results[tree].append(line)
            print(json.dumps(line), flush=True)
    keys = ("ms_read_flush", "ms_zero_flush", "back_to_back_ms",
            "host_us_per_call")
    print(json.dumps({"summary": {
        tree: {k: statistics.median(t[k] for t in turns) for k in keys}
        for tree, turns in results.items() if turns},
        "turns": {tree: len(turns) for tree, turns in results.items()},
        "failed_turns": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

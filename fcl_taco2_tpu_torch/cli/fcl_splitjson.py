#!/usr/bin/env python3
"""Split a data.json manifest into N shards for parallel decoding (the
port's copy of ``fcl_taco2_tpu/cli/fcl_splitjson.py``).

    python -m fcl_taco2_tpu_torch.cli.fcl_splitjson data.json --parts 2

Parity with the reference's splitjson.py (inference_teacher.sh:3); shards
go to <dir>/split<N>utt/<name>.<k>.json.
"""

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("json_path")
    p.add_argument("--parts", "-p", type=int, default=50)
    args = p.parse_args(argv)

    with open(args.json_path) as f:
        utts = json.load(f)["utts"]
    keys = sorted(utts.keys())
    n = len(keys)
    if n < args.parts:
        raise SystemExit(
            f"#utterances ({n}) < #splits ({args.parts})"
        )  # reference splitjson errors here too
    base = os.path.basename(args.json_path).rsplit(".", 1)[0]
    out_dir = os.path.join(os.path.dirname(args.json_path),
                           f"split{args.parts}utt")
    os.makedirs(out_dir, exist_ok=True)
    # np.array_split balancing: no shard is empty and sizes differ by <=1
    bounds = [round(i * n / args.parts) for i in range(args.parts + 1)]
    for k in range(args.parts):
        shard = {u: utts[u] for u in keys[bounds[k]:bounds[k + 1]]}
        out = os.path.join(out_dir, f"{base}.{k + 1}.json")
        with open(out, "w") as f:
            json.dump({"utts": shard}, f, indent=4, sort_keys=True)
    print(f"wrote {args.parts} shards to {out_dir} ({n} utts)")


if __name__ == "__main__":
    main()

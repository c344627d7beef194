"""Same-card comparison of two trees' v2 and PSE paths, in alternating processes.

    python3 scripts/paths_ab.py OLD_ROOT NEW_ROOT [rounds]

Each round runs one process a tree in the order old, new, new, old (the
host varies between processes, so neither tree always runs first). A
process imports the tree's ``uammd_tpu_torch`` (built into that tree's
``_build/``) and drives it with this checkout's ``chip_smoke.py``, the
same harness for both trees: ``melt``, ``main_path_v2`` (bench.py's v2
path: 100 settle and 200 timed steps, its gates and launch counts:
ms/step), ``pse_run`` (40 + 40 persistent PSE steps: ms/step) and
``pse_profile`` (5 steps under the profiler: the device work a step).
Prints each process's line and the median and quartiles of each metric a
tree, then everything as one JSON line. Needs one GPU.

``python3 scripts/paths_ab.py --one ROOT LABEL`` runs one process's share.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HARNESS = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "chip_smoke.py")


def one(root, label):
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HARNESS)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from uammd_tpu_torch.engine import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build()
    out = {"tree": label, "build_s": time.perf_counter() - t0}
    v2 = cs.main_path_v2(dev, cs.melt(dev), cs.v2_counters())
    out["v2_ms_per_step"] = v2["ms"]
    del v2
    torch.cuda.empty_cache()
    run = cs.pse_run(dev, cs.pse_counters(), cs.PSE_STRAG, 0)
    out["pse_ms_per_step"] = 1e3 * run["timed_s"] / cs.PSE_TIMED
    prof = cs.pse_profile(run)
    out["pse_device_ms_per_step"] = prof["device_ms_per_step"]
    out["pse_device_busy_share"] = prof["device_busy_share"]
    print("PATHS " + json.dumps(out), flush=True)


def quartiles(xs):
    xs = sorted(xs)
    if len(xs) < 2:
        return xs * 3
    q = statistics.quantiles(xs, n=4)
    return [q[0], statistics.median(xs), q[2]]


def main():
    if sys.argv[1] == "--one":
        one(sys.argv[2], sys.argv[3])
        return 0
    roots = {"old": sys.argv[1], "new": sys.argv[2]}
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for _ in range(rounds):
        for label in ("old", "new", "new", "old"):
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                                roots[label], label], capture_output=True, text=True)
            lines = [ln for ln in p.stdout.splitlines() if ln.startswith("PATHS ")]
            if p.returncode or not lines:
                print(p.stdout[-3000:], p.stderr[-3000:], flush=True)
                raise RuntimeError(f"{label} run failed ({p.returncode})")
            runs.append(json.loads(lines[-1][6:]))
            print(lines[-1], flush=True)
    summary = {}
    for label in ("old", "new"):
        mine = [r for r in runs if r["tree"] == label]
        summary[label] = {k: quartiles([r[k] for r in mine if r[k] is not None])
                          for k in ("v2_ms_per_step", "pse_ms_per_step",
                                    "pse_device_ms_per_step")}
        summary[label]["runs"] = len(mine)
    out = {"card": smi, "order": "old, new, new, old a round", "rounds": rounds,
           "quartiles_median": summary, "runs": runs}
    print(json.dumps(summary), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

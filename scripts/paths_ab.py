"""Same-card comparison of two trees' paths, in alternating processes.

    python3 scripts/paths_ab.py OLD_ROOT NEW_ROOT [rounds] [--paths v2,pse]

Each round runs one process a tree in the order old, new, new, old (the
host varies between processes, so neither tree always runs first). A
process imports the tree's ``uammd_tpu_torch`` (built into that tree's
``_build/``) and drives it with this checkout's ``chip_smoke.py``, the
same harness for both trees: ``melt``, ``main_path_v2`` (bench.py's v2
path: 100 settle and 200 timed steps, its gates and launch counts:
ms/step), ``pse_run`` (40 + 40 persistent PSE steps: ms/step) and
``pse_profile`` (5 steps under the profiler: the device work a step).
``--paths`` picks among those (``v2``, ``pse``) and two more: ``unfused``
(the unfused v2 engine, ``fold_in_update=False``, from the melt: 100
settle and 200 timed steps: ms/step) and ``dd2_4`` (``main_path_dd2`` on
4 shards: 100 settle and 200 timed steps, its gates: ms/step); the
default is ``v2,pse``. Prints each process's line and the median and
quartiles of each metric a tree, then everything as one JSON line. Needs
one GPU.

``python3 scripts/paths_ab.py --one ROOT LABEL PATHS`` runs one process's
share.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HARNESS = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "chip_smoke.py")


METRICS = {"v2": ("v2_ms_per_step",), "pse": ("pse_ms_per_step", "pse_device_ms_per_step"),
           "unfused": ("unfused_ms_per_step",), "dd2_4": ("dd2_4_ms_per_step",)}


def one(root, label, paths):
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
    melted = cs.melt(dev)
    if "v2" in paths:
        v2 = cs.main_path_v2(dev, melted, cs.v2_counters())
        out["v2_ms_per_step"] = v2["ms"]
        del v2
        torch.cuda.empty_cache()
    if "unfused" in paths:
        engine = cs.unfused_engine(dev, melted, fold_in_update=False)
        gs = engine.run(engine.init(melted, seed=1), cs.SETTLE_STEPS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gs = engine.run(gs, cs.TIMED_STEPS)
        torch.cuda.synchronize()
        out["unfused_ms_per_step"] = 1e3 * (time.perf_counter() - t1) / cs.TIMED_STEPS
        cs.check(not bool(gs.overflow), "unfused path: no overflow")
        del engine, gs
        torch.cuda.empty_cache()
    if "dd2_4" in paths:
        out["dd2_4_ms_per_step"] = cs.main_path_dd2(dev, "", melted, 4)["ms"]
        torch.cuda.empty_cache()
    if "pse" in paths:
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
        one(sys.argv[2], sys.argv[3], sys.argv[4].split(","))
        return 0
    args = sys.argv[1:]
    paths = "v2,pse"
    if "--paths" in args:
        k = args.index("--paths")
        paths = args[k + 1]
        del args[k:k + 2]
    roots = {"old": args[0], "new": args[1]}
    rounds = int(args[2]) if len(args) > 2 else 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for _ in range(rounds):
        for label in ("old", "new", "new", "old"):
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                                roots[label], label, paths], capture_output=True, text=True)
            lines = [ln for ln in p.stdout.splitlines() if ln.startswith("PATHS ")]
            if p.returncode or not lines:
                print(p.stdout[-3000:], p.stderr[-3000:], flush=True)
                raise RuntimeError(f"{label} run failed ({p.returncode})")
            runs.append(json.loads(lines[-1][6:]))
            print(lines[-1], flush=True)
    summary = {}
    for label in ("old", "new"):
        mine = [r for r in runs if r["tree"] == label]
        keys = [k for p in paths.split(",") for k in METRICS[p]]
        summary[label] = {k: quartiles([r[k] for r in mine if r[k] is not None]) for k in keys}
        summary[label]["runs"] = len(mine)
    out = {"card": smi, "order": "old, new, new, old a round", "rounds": rounds, "paths": paths,
           "quartiles_median": summary, "runs": runs}
    print(json.dumps(summary), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

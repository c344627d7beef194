"""Same-card A/B of the G-J update from folded forces #11 (``gj_update.cu``)
and the one-shot straggler rebin #4 (``rebin2.cu``) against an older tree's.

    python3 scripts/kernel_ab.py OLD_PACKAGE_DIR [rounds]

``OLD_PACKAGE_DIR`` is a copy of an older tree's ``uammd_tpu_torch`` under
another name, for example::

    mkdir -p _archive/ab && git archive <commit> uammd_tpu_torch | tar -x -C _archive/ab
    mv _archive/ab/uammd_tpu_torch _archive/ab/uammd_tpu_torch_old

The package imports itself only relatively, so it loads under that name
beside this checkout's, and builds its kernels into ``_archive/ab/_build``.
One process on one GPU: this checkout's ``chip_smoke.py`` makes the states
(the v1 melt; the unfused v2 engine's settle steps, keeping every state it
rebins; its final state; the DD2 engine on 4 shards and on 1 after
``DD_SETTLE`` steps), and each row runs through each tree's own wrapper
as its engine calls it:

- ``gj_update_unfused``: #11 at the unfused path's final state
  ([42, 10, 32, 128], S 16, the rows' pids as int32), one call;
- ``gj_update_dd2_4`` / ``_1``: one DD2 step's launches, one a shard, in
  the form each tree's ``DomainMD2Step`` makes them: the older tree with
  the rows' pids converted to int32 beforehand (the conversion and the
  rows' drift outside the timing, as its ``chip_smoke.dd_update_row``
  took them), the newer with the state's float32 pid + 1 and the rows'
  references (their drift inside the launch);
- ``..._step_phase``: the same sweeps with each tree's whole per-shard
  update phase of the step (the older one's pid conversion and five torch
  launches of the rows' drift included);
- ``rebin2_settle``: #4 on every state the unfused path rebinned in its
  settle steps, one call each.

Each row is timed in turns old, new, new, old for ``rounds`` rounds (20
calls a turn; a ``rebin2_settle`` turn is one call a state), with CUDA
events; then once a tree by the profiler (the L2 flushed before each
call: ``chip_smoke.profiler_ms(cold=True)``) and on the host
(``chip_smoke.host_us``, a launch). The two trees' outputs are held equal
first (#4 bit for bit, #11 bit for bit on these finite states). Prints the
card, a JSON line a row and one line with all rows.
"""

import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, os.pardir))


def load_harness():
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def turns(fns, rounds, cs):
    """{label: [ms a call of each turn]} over rounds of old, new, new, old;
    a turn is 20 calls (``fn`` repeated when it makes fewer)."""
    out = {k: [] for k in fns}
    for _ in range(rounds):
        for label in ("old", "new", "new", "old"):
            fn, calls = fns[label]
            reps = max(1, 20 // calls)
            out[label].append(cs.cuda_ms(fn, reps=reps, warmup=1) / calls)
    return out


def host_parts(cs, kern, grids, seed, strag) -> dict:
    """The newer #11 wrapper's host time a call (us, ``chip_smoke.host_us``)
    by part: the 12 grids' checks, the output buffer, the data pointers,
    the output views, the C entry alone (a launch), and the whole call."""
    import torch
    from uammd_tpu_torch.engine import _build
    from uammd_tpu_torch.engine import update_kernel as uk

    T, S = kern._T, strag[3].shape[0]
    dev = grids[0].device
    buf = torch.empty(6 * T + 6 * S + 1, dtype=torch.float32, device=dev)
    scratch = uk.gj_update_scratch(dev, kern.spec, S)
    args = ([t.data_ptr() for t in grids] + [buf.data_ptr(), seed.data_ptr(),
            scratch.data_ptr(), scratch.numel()] + [t.data_ptr() for t in strag]
            + [0, None, S, kern._params_at])
    parts = {
        "check_12_grids": lambda: _build.check_cuda_tensors(grids, "update grid", kern._shape),
        "empty_buffer": lambda: torch.empty(6 * T + 6 * S + 1, dtype=torch.float32, device=dev),
        "data_ptrs_17": lambda: [t.data_ptr() for t in grids + list(strag)],
        "output_views": lambda: (buf.as_strided(*kern._grids_at).unbind(0), buf[6 * T + 6 * S],
                                 buf.as_strided((S, 3), (3, 1), 6 * T),
                                 buf.as_strided((S, 3), (3, 1), 6 * T + 3 * S)),
        "c_entry_launch": lambda: uk.GJ_UPDATE(*args),
        "whole_call": lambda: kern(*grids, seed, strag),
    }
    return {k: cs.host_us(fn) for k, fn in parts.items()}


def main():
    import torch

    cs = load_harness()
    old_dir = os.path.abspath(sys.argv[1])
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    sys.path.insert(0, os.path.dirname(old_dir))
    old = importlib.import_module(os.path.basename(old_dir))
    old_uk = importlib.import_module(old.__name__ + ".engine.update_kernel")
    old_rk = importlib.import_module(old.__name__ + ".engine.rebin_kernel")
    old_build = importlib.import_module(old.__name__ + ".engine._build")
    from uammd_tpu_torch.engine import _build, md2
    from uammd_tpu_torch.engine import rebin_kernel as rk
    from uammd_tpu_torch.engine import update_kernel as uk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    old_build.build(["gj_update", "rebin2"])
    _build.build()
    dev = torch.device("cuda")
    melted = cs.melt(dev)

    # the unfused path's settle steps, keeping each state it rebins
    engine = cs.unfused_engine(dev, melted, fold_in_update=False)
    real, settle = md2.rebin_fast3, []

    def keep(gs):
        settle.append((cs.stacked_of(gs, 7), cs.strag_stack_of(gs)))
        return real(gs)

    md2.rebin_fast3 = keep
    try:
        gs = engine.run(engine.init(melted, seed=1), cs.SETTLE_STEPS)
    finally:
        md2.rebin_fast3 = real
    spec = engine.spec
    rows = {}

    def row(name, fns, names, launches, check_equal):
        check_equal()
        t = turns(fns, rounds, cs)
        r = {"row": name}
        for label, (fn, calls) in fns.items():
            cold = cs.profiler_ms(fn, names[label], reps=10, cold=True)
            r[label] = {"ms_turns": t[label], "ms_median": statistics.median(t[label]),
                        "device_ms_cold": (None if cold["kernels_ms"] is None
                                           else cold["kernels_ms"] / calls),
                        "host_us_a_launch": cs.host_us(fn, n=20) / (calls * launches)}
        r["new_over_old"] = r["new"]["ms_median"] / r["old"]["ms_median"]
        rows[name] = r
        print(json.dumps(r), flush=True)

    def same(a, b):
        return all(torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)) for x, y in zip(a, b))

    # #11 on the unfused path's final state
    a, ref, step, s_rows = cs.gj_inputs(gs, 41)
    k_old = old_uk.make_gj_update_kernel(spec, 0.01, cs.TEMPERATURE, 1.0, 1.0)
    k_new = uk.make_gj_update_kernel(spec, 0.01, cs.TEMPERATURE, 1.0, 1.0)

    def eq_unfused():
        o, n = k_old(*a, *ref, step, s_rows), k_new(*a, *ref, step, s_rows)
        cs.check(same(o[0] + o[2], n[0] + n[2]) and float(o[1]) == float(n[1]),
                 "#11 unfused: the two trees agree bit for bit")

    row("gj_update_unfused", {"old": (lambda: k_old(*a, *ref, step, s_rows), 1),
                              "new": (lambda: k_new(*a, *ref, step, s_rows), 1)},
        {"old": ["gj_update_kernel"], "new": ["gj_update_rows"]}, 1, eq_unfused)
    parts = host_parts(cs, k_new, list(a) + list(ref), step, s_rows)
    rows["gj_update_unfused"]["new"]["host_us_by_part"] = parts
    print(json.dumps({"row": "gj_update_unfused", "new_host_us_by_part": parts}), flush=True)
    del a, ref, s_rows

    # #11 in the DD2 steps
    for n_shards in (4, 1):
        dstep, st, _, _ = cs.dd2_setup(dev, melted, n_shards)
        for _ in range(cs.DD_SETTLE):
            st = dstep(st)
        lspec = dstep.local_spec
        ko = old_uk.make_gj_update_kernel(lspec, 0.01, cs.TEMPERATURE, 1.0, 1.0)
        kn = dstep.upd
        g = [(st.x[i], st.y[i], st.z[i], st.wx[i], st.wy[i], st.wz[i], st.fx[i], st.fy[i],
              st.fz[i], st.rx[i], st.ry[i], st.rz[i]) for i in range(n_shards)]
        spid = [s.to(torch.int32) - 1 for s in st.spidf]

        def rows_of(i, ids):
            return (st.spos[i], st.svelw[i], st.sforce[i], ids[i])

        def old_sweep():
            return [ko(*g[i], st.stepc[i], rows_of(i, spid)) for i in range(n_shards)]

        def new_sweep():
            return [kn(*g[i], st.stepc[i], rows_of(i, st.spidf), st.sref[i])
                    for i in range(n_shards)]

        def old_phase():  # the older DomainMD2Step's update phase
            dinfs = []
            for i in range(n_shards):
                ids = st.spidf[i].to(torch.int32) - 1
                res = ko(*g[i], st.stepc[i], (st.spos[i], st.svelw[i], st.sforce[i], ids))
                sm = (st.spidf[i] > 0.5)[:, None]
                sd = torch.where(sm, torch.abs(res[2][0] - st.sref[i]),
                                 torch.zeros((), device=dev)).max()
                dinfs.append(torch.maximum(res[1], sd))
            return dinfs

        def new_phase():
            return [kn(*g[i], st.stepc[i], rows_of(i, st.spidf), st.sref[i])[1]
                    for i in range(n_shards)]

        def eq_dd():
            for o, n in zip(old_sweep(), new_sweep()):
                cs.check(same(o[0] + o[2], n[0] + n[2]), "#11 DD2: the two trees agree")
            for o, n in zip(old_phase(), new_phase()):
                cs.check(float(o) == float(n), f"#11 DD2: the drifts agree {o} {n}")

        suffix = f"_{n_shards}"
        names = {"old": ["gj_update_kernel"], "new": ["gj_update_rows"]}
        row("gj_update_dd2" + suffix, {"old": (old_sweep, 1), "new": (new_sweep, 1)}, names,
            n_shards, eq_dd)
        row("gj_update_dd2" + suffix + "_step_phase", {"old": (old_phase, 1),
                                                       "new": (new_phase, 1)},
            names, n_shards, lambda: None)
        del dstep, st, g, spid
        torch.cuda.empty_cache()

    # #4 on every state the unfused path rebinned in its settle steps
    r_old, r_new = old_rk.make_rebin_kernel2(spec), rk.make_rebin_kernel2(spec)

    def eq_rebin2():
        for stacked, strag in settle:
            o, n = r_old(stacked, strag), r_new(stacked, strag)
            cs.check(torch.equal(o[0], n[0]) and torch.equal(o[1], n[1])
                     and int(o[2]) == int(n[2]) and int(o[3]) == int(n[3]),
                     "#4: the two trees agree bit for bit, counts too")

    row("rebin2_settle", {"old": (lambda: [r_old(*s) for s in settle], len(settle)),
                          "new": (lambda: [r_new(*s) for s in settle], len(settle))},
        {"old": ["rebin2_kernel"], "new": ["rebin2_pull", "rebin_classify"]}, 1, eq_rebin2)
    print(json.dumps({"card": smi, "order": "old, new, new, old a round", "rounds": rounds,
                      "settle_states": len(settle), "shape": list(spec.array_shape),
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

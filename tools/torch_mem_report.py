#!/usr/bin/env python
"""Peak-memory planner CLI of the PyTorch port (the reporting face of
``paddle_tpu_torch.analysis.liveness``; counterpart of
tools/mem_report.py's single-device half, with its report keys).

Usage:
  python tools/torch_mem_report.py
      Plan the test-book programs (mnist-mlp and seq2seq train, plus the
      torch_lint_program.py --builtin suite): per program, print the
      estimated peak live bytes and the top-10 live-range hot spots with
      build sites.
  python tools/torch_mem_report.py prog.json [prog2.json ...]
      Plan serialized programs (Program.to_json output).
  python tools/torch_mem_report.py --check [--json report.json]
      CI gate: also run the liveness verifier pass (PT5xx) over every
      program and exit 1 on any *error*-severity PT5xx finding; --json
      writes the full machine-readable report (the CI artifact).
  python tools/torch_mem_report.py --mesh dp=2 --specs zero1
      PER-RANK mode: plan every program under the mesh + layout as well
      (``--specs`` is ``allreduce`` (default), ``zero1`` or a JSON file
      of name -> [axis|null, ...] specs). Each JSON entry gains a
      "per_chip" section: the per-rank plan, the collective wire volumes
      and the predicted comms/compute ratio.

The plan is static: nothing runs on a device. ``--validate-live`` and
``--hbm-budget-mb`` (a per-rank budget) under ``--mesh`` raise: they wait
for ROADMAP Queue A item 6, slice 25.

Options: --batch N (resolve -1 dims, default 64), --top K (hot spots).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch.analysis import Severity, verify_program  # noqa: E402
from tools import torch_gate_probes as probes  # noqa: E402


def _book_programs():
    """(name, program, feed_names, fetch_names) for the book models the
    test suite trains (mnist-mlp, seq2seq) and the lint builtin suite."""
    import paddle_tpu_torch.unique_name as un
    from paddle_tpu_torch.models.mlp import build_mnist_mlp
    from paddle_tpu_torch.models.seq2seq import build_seq2seq_train

    out = []
    with un.guard():
        m = build_mnist_mlp()
        out.append(("mnist_mlp/main", m["main"], list(m["feeds"]),
                    [m["loss"].name, m["acc"].name]))
        out.append(("mnist_mlp/startup", m["startup"], [], []))
    with un.guard():
        s = build_seq2seq_train(src_vocab=50, tgt_vocab=50)
        out.append(("seq2seq/main", s["main"], list(s["feeds"]),
                    [s["loss"].name]))
        out.append(("seq2seq/startup", s["startup"], [], []))

    from tools import torch_lint_program as lint

    for name, prog, fetches in lint._builtin_programs():
        feeds = [v.name for v in prog.global_block.vars.values()
                 if v.is_data]
        out.append((name, prog, feeds, fetches))
    return out


def _parse_mesh(s):
    """'dp=2' -> {'dp': 2}"""
    mesh = {}
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        mesh[k.strip()] = int(v)
    if not mesh:
        raise ValueError(f"empty mesh spec {s!r}")
    return mesh


def _specs_for(program, mesh, specs_mode):
    """Resolve --specs for one program: a layout name or a JSON file;
    anything else is an error (a typo'd spec file silently degrading to
    the replicated layout would make the gate check the wrong thing)."""
    from paddle_tpu_torch.parallel.sharding import extract_param_specs

    mode = (specs_mode or "allreduce").lower()
    if mode not in ("zero1", "allreduce"):
        if not os.path.exists(specs_mode):
            raise SystemExit(
                f"--specs {specs_mode!r} is neither 'zero1', 'allreduce' "
                f"nor an existing JSON spec file")
        with open(specs_mode, "r", encoding="utf-8") as f:
            raw = json.load(f)
        return {k: tuple(v) for k, v in raw.items()}
    specs, _feed = extract_param_specs(program, mesh, zero=mode == "zero1")
    return specs


def _per_chip_entry(program, feeds, fetches, batch, mesh, specs_mode):
    """The per-rank section of one program's JSON entry."""
    from paddle_tpu_torch.analysis.cost_model import (comms_compute_ratio,
                                                      estimate_comms,
                                                      estimate_cost)

    specs = _specs_for(program, mesh, specs_mode)
    plan = program.memory_plan(feed_names=feeds, fetch_names=fetches,
                               batch_size=batch, mesh=mesh, specs=specs)
    analysis = plan.sharding
    comms = estimate_comms(analysis)
    cost = estimate_cost(program, batch_size=batch)
    section = {
        "mesh": dict(analysis.mesh),
        "specs_mode": specs_mode or "allreduce",
        "plan": plan.to_dict(),
        "sharding": analysis.to_dict(),
        "comms": comms.to_dict(),
        "comms_compute_ratio": round(
            comms_compute_ratio(comms, cost), 4),
    }
    return plan, section


def _report_one(name, program, feed_names, fetch_names, batch, top,
                check: bool, mesh=None, specs_mode=None):
    plan = program.memory_plan(feed_names=feed_names,
                               fetch_names=fetch_names, batch_size=batch)
    entry = {"name": name, "feeds": list(feed_names),
             "fetches": list(fetch_names), "plan": plan.to_dict()}
    chip_plan = None
    if mesh:
        chip_plan, entry["per_chip"] = _per_chip_entry(
            program, feed_names, fetch_names, batch, mesh, specs_mode)
    gate_errors = []
    if check:
        diags = verify_program(program, fetch_names=fetch_names,
                               passes=("liveness",))
        entry["diagnostics"] = [
            {"code": d.code, "severity": d.severity, "message": d.message,
             "block": d.block_idx, "op": d.op_idx, "op_type": d.op_type}
            for d in diags]
        gate_errors = [d for d in diags
                       if d.code.startswith("PT5")
                       and d.severity == Severity.ERROR]
    status = "FAIL" if gate_errors else "ok"
    print(f"[{status}] {name}")
    print("  " + plan.format(top).replace("\n", "\n  "))
    if chip_plan is not None:
        print("  " + chip_plan.format(top).replace("\n", "\n  "))
        comms = entry["per_chip"]["comms"]
        print(f"  collectives: {comms['gbytes_per_step'] * 1000:.3f} "
              f"MB/rank/step on the wire, predicted comms/compute "
              f"{entry['per_chip']['comms_compute_ratio']:.3f}")
    if check:
        n = len(entry["diagnostics"])
        print(f"  liveness findings: {n} "
              f"({len(gate_errors)} error-severity PT5xx)")
        for d in gate_errors:
            print(f"    {d}")
    return entry, not gate_errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("programs", nargs="*",
                    help="serialized Program JSON files (default: the "
                         "test-book programs)")
    ap.add_argument("--check", action="store_true",
                    help="run the PT5xx liveness pass; exit 1 on "
                         "error-severity findings (the CI gate)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full report as JSON (CI artifact)")
    ap.add_argument("--batch", type=int, default=64,
                    help="batch size substituted for -1 dims (default 64)")
    ap.add_argument("--top", type=int, default=10,
                    help="hot spots to print per program (default 10)")
    ap.add_argument("--mesh", default=None,
                    help="per-rank mode: 'dp=2'")
    ap.add_argument("--specs", default=None,
                    help="layout under --mesh: allreduce (default), zero1 "
                         "or a JSON spec file")
    ap.add_argument("--hbm-budget-mb", type=float, default=0.0,
                    help="per-rank budget under --mesh (raises: slice 25)")
    ap.add_argument("--validate-live", action="store_true",
                    help="live per-rank validation (raises: slice 25)")
    args = ap.parse_args(argv)

    if args.specs and not args.mesh:
        ap.error("--specs needs --mesh")
    for opt, on in (("--hbm-budget-mb", args.hbm_budget_mb),
                    ("--validate-live", args.validate_live)):
        if on:
            probes.refuse_multi_device(f"mem_report {opt}")
    mesh = _parse_mesh(args.mesh) if args.mesh else None

    targets = []
    if args.programs:
        for path in args.programs:
            with open(path, "r", encoding="utf-8") as f:
                prog = fluid.Program.from_json(f.read())
            feeds = [v.name for v in prog.global_block.vars.values()
                     if v.is_data]
            targets.append((path, prog, feeds, []))
    else:
        targets = _book_programs()

    ok = True
    report = {"batch_size": args.batch, "programs": []}
    for name, prog, feeds, fetches in targets:
        entry, good = _report_one(name, prog, feeds, fetches, args.batch,
                                  args.top, args.check, mesh, args.specs)
        report["programs"].append(entry)
        ok = ok and good
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
        print(f"report written to {args.json}")
    if args.check:
        print(f"memory gate -> {'ok' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

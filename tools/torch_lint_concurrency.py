#!/usr/bin/env python
"""Concurrency static-analysis linter CLI of the PyTorch port (CI face of
paddle_tpu_torch.analysis.concurrency; counterpart of
tools/lint_concurrency.py, with the same exit codes, JSON artifact and
negative control).

Runs the source-level lock analysis over the whole ``paddle_tpu_torch``
package (or explicit files): inventories every named lock, builds the
static lock-order graph, and reports the PT800 family —

  PT800  lock-order cycle (or non-reentrant self-acquisition)  ERROR
  PT801  blocking call while holding a lock                    WARNING
  PT802  cross-thread attribute with unguarded access          WARNING

ALL three codes gate (a deadlock does not become acceptable by being
a warning); a finding is either fixed or allowlisted below with the
reason on record.

Usage:
  python tools/torch_lint_concurrency.py
      Lint the paddle_tpu_torch package (the ci/run_torch_gates.sh gate).
  python tools/torch_lint_concurrency.py path/to/file.py [more.py ...]
      Lint explicit files (fixtures, subsets).
  --json PATH          machine-readable report: lock inventory, static
                       edge list, findings, allowlist hits.
                       tools/torch_load_check.py --lock-witness
                       --concurrency-json PATH merges its runtime
                       ``lock_witness`` section into the same file.
  --negative-control   lint the intentionally-broken fixtures under
                       tests/fixtures/concurrency with an EMPTY
                       allowlist; the gate must trip on all three
                       codes (proves the linter can fail).

Exit status (stable, for CI):
  0  clean — no gating findings
  1  findings — PT800/PT801/PT802 not covered by the allowlist
  2  internal error — the linter itself failed (never conflate a
     linter crash with a lint finding)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from paddle_tpu_torch.analysis.concurrency import (  # noqa: E402
    analyze_package, analyze_paths)

# Findings the gate accepts, with the reason on record. Matched on
# (code, key) where key is the stable finding key: the PT801 key is
# ``<function qualname>+<blocking call>``, the PT802 key is
# ``<Class>.<attr>`` — both independent of line numbers.
ALLOWLIST = {
    ("PT801", "paddle_tpu_torch.kernels._build.load+subprocess.run"):
        "nvcc runs under the kernel's own per-name lock (_name_locks[name]) "
        "BY DESIGN: the lock is what makes one source build once per "
        "process — a thread that needs this kernel cannot launch until "
        "its library exists, so releasing the lock would only start a "
        "second nvcc of the same source; threads that need another "
        "kernel take another lock and build in parallel",
    ("PT801", "paddle_tpu_torch.kernels._build._compile+subprocess.run"):
        "the nvcc call itself, reached only from load() under the "
        "per-name build lock (the entry above)",
    ("PT801", "paddle_tpu_torch.native.load_datafeed+subprocess.run"):
        "g++ builds the native MultiSlot parser once per process under "
        "native._lock: the DataFeed that asked for it cannot parse until "
        "the library exists, and a second caller must wait for that one "
        "build, not start its own; the build is cached by source hash, "
        "so it runs on the first load only",
    ("PT801", "paddle_tpu_torch.native._compile+subprocess.run"):
        "the g++ call itself, reached only from load_datafeed() under "
        "native._lock (the entry above)",
    ("PT801", "paddle_tpu_torch.executor.Executor._ensure_prepared"
              "+time.sleep"):
        "the compile fault_point runs (through call_with_retry) under the "
        "per-step _aot_lock BY DESIGN: the lock is what makes a step's "
        "preparation happen once — contending threads need this step and "
        "cannot progress until it is prepared, so releasing the lock "
        "would only let them re-fail the same preparation. The sleep is "
        "FaultPlan._perform's 'hang' action, which simulates a stuck "
        "thread where the probe sits on purpose and fires only under an "
        "explicit FLAGS_fault_plan (the retry backoff itself waits on an "
        "Event with a timeout)",
    ("PT801", "paddle_tpu_torch.serving.engine.ServingEngine._admit_locked"
              "+time.sleep"):
        "the admission fault_point ('overload') reaches FaultPlan._perform, "
        "whose 'hang' action sleeps in a loop ON PURPOSE: the fault "
        "simulates a stuck thread wherever the probe sits, engine lock "
        "included — the watchdog/chaos harness is what detects and "
        "recovers it; fires only under an explicit FLAGS_fault_plan",
    ("PT801", "paddle_tpu_torch.serving.engine.ServingEngine"
              "._admit_and_enqueue+time.sleep"):
        "transitive face of the _admit_locked entry above (the "
        "with-_lock caller of the admission fault_point)",
    ("PT802", "ServingEngine._acct"):
        "_settle_error's locked= flag protocol: the locked=True branch is "
        "only reachable from callers already inside _lock (enforced by "
        "the call sites; the dispatch thread owns the other branch), so "
        "every _acct mutation is lock-serialized even though one access "
        "site is lexically outside a with-block",
    ("PT802", "ServingEngine._dispatched"):
        "same locked= flag protocol as ServingEngine._acct: the lexically "
        "unguarded write runs only on the locked=True path whose callers "
        "hold _lock",
    ("PT802", "ServingEngine._breakers"):
        "single-writer dict: only the dispatch thread creates/advances "
        "breaker entries, and each mutation happens under _lock so "
        "health() can snapshot a consistent view; the lexically unguarded "
        "site is the dispatch thread's read of its own writes",
    ("PT802", "ServingEngine._quarantine"):
        "racy fast-path read at admission: a stale read only delays "
        "quarantine by one request; the race is closed by the "
        "authoritative re-check under _lock in _admit_locked",
    ("PT802", "FleetRouter.replicas"):
        "copy-on-write list: mutators replace the whole list under "
        "_lock, readers snapshot the reference — the unguarded reads are "
        "the design",
}

# every PT800-family finding gates unless allowlisted
GATING_CODES = ("PT800", "PT801", "PT802")

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "..",
                           "tests", "fixtures", "concurrency")


def _diag_dict(d) -> dict:
    return {"code": d.code, "severity": d.severity, "key": d.op_type,
            "message": d.message, "site": d.site}


def _lint(name: str, report, allowlist: dict, json_report: dict) -> bool:
    gating, allow_hits, findings = [], [], []
    for d in report.diagnostics:
        findings.append(d)
        if d.code not in GATING_CODES:
            continue
        reason = allowlist.get((d.code, d.op_type or ""), "")
        if reason:
            allow_hits.append((d, reason))
        else:
            gating.append(d)
    cycles = sum(d.code == "PT800" for d in findings)
    status = "FAIL" if gating else "ok"
    print(f"[{status}] {name}: {len(report.modules)} modules, "
          f"{report.functions} functions, {len(report.locks)} locks, "
          f"{len(report.edges)} lock-order edges, {cycles} PT800, "
          f"{len(findings)} finding(s), {len(allow_hits)} allowlisted")
    for d in gating:
        print(f"  {d.code} [{d.severity}] {d.site}: {d.message}")
    summary = report.to_dict()
    summary.pop("diagnostics")       # carried (keyed) in "findings" below
    json_report["targets"].append({
        "name": name,
        "status": "fail" if gating else "ok",
        "summary": summary,
        "findings": [_diag_dict(d) for d in findings],
        "gating": [_diag_dict(d) for d in gating],
        "allowlisted": [dict(_diag_dict(d), reason=r)
                        for d, r in allow_hits],
    })
    if gating:
        print(f"concurrency gate -> FAIL ({name}: {len(gating)} "
              f"non-allowlisted finding(s))")
    return not gating


def _negative_control(json_report: dict) -> int:
    """Fixtures must trip all three codes with the allowlist OFF."""
    paths = sorted(os.path.join(FIXTURE_DIR, f)
                   for f in os.listdir(FIXTURE_DIR) if f.endswith(".py"))
    report = analyze_paths(paths, root=FIXTURE_DIR)
    ok = _lint("negative-control(fixtures)", report, {}, json_report)
    tripped = {d.code for d in report.diagnostics}
    missing = [c for c in GATING_CODES if c not in tripped]
    if missing:
        # a control that cannot trip every family is a broken control,
        # not a gate failure — exit 2 so CI's "-> FAIL" grep flags it
        print(f"negative control did NOT produce {', '.join(missing)} "
              f"on the fixtures — the linter lost coverage", file=sys.stderr)
        return 2
    if ok:
        print("negative control found nothing gating on intentionally "
              "broken fixtures", file=sys.stderr)
        return 0   # CI inverts the exit status: 0 here fails the build
    return 1


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("files", nargs="*",
                    help="explicit .py files (default: the whole "
                         "paddle_tpu_torch package)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--negative-control", action="store_true",
                    help="lint the broken fixtures with an empty "
                         "allowlist; must FAIL")
    args = ap.parse_args(argv)

    json_report = {
        "targets": [],
        "allowlist": [{"code": c, "key": k, "reason": r}
                      for (c, k), r in sorted(ALLOWLIST.items())],
    }
    if args.negative_control:
        rc = _negative_control(json_report)
        json_report["status"] = "negative-control"
        code = rc
    else:
        if args.files:
            ok = _lint("files", analyze_paths(args.files), ALLOWLIST,
                       json_report)
        else:
            ok = _lint("paddle_tpu_torch", analyze_package(), ALLOWLIST,
                       json_report)
        json_report["status"] = "ok" if ok else "fail"
        code = 0 if ok else 1
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(json_report, f, indent=2, sort_keys=True)
        print(f"report -> {args.json}")
    return code


def main(argv=None) -> int:
    """Stable CI exit codes: 0 clean, 1 findings, 2 internal error."""
    try:
        return run(argv)
    except SystemExit as e:  # argparse error: also an internal error
        code = e.code if isinstance(e.code, int) else 2
        return code if code in (0, 1) else 2
    except Exception:
        traceback.print_exc()
        return 2


if __name__ == "__main__":
    sys.exit(main())

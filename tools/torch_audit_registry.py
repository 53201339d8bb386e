#!/usr/bin/env python
"""Op-registry conformance/coverage audit CLI of the PyTorch port
(counterpart of tools/audit_registry.py, over paddle_tpu_torch's registry).

Dumps one row per registered op: infer_shape source (explicit/auto), lower
rule presence, grad story (auto-vjp / custom / none), rng & raw flags, and
whether any test file references the op. Makes registry gaps visible instead
of latent.

  python tools/torch_audit_registry.py              # table to stdout
  python tools/torch_audit_registry.py --json       # machine-readable to stdout
  python tools/torch_audit_registry.py --json-file audit.json   # CI artifact
  python tools/torch_audit_registry.py --strict     # exit 1 if any op lacks a
                                              # lower rule (CI gate)
  python tools/torch_audit_registry.py --untested   # only ops no test mentions

Exit status (stable, for CI): 0 clean, 1 findings under --strict (an op
without a lower rule), 2 internal error (the auditor itself failed).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import paddle_tpu_torch  # noqa: F401,E402  (registers all ops)
from paddle_tpu_torch.analysis import (  # noqa: E402
    audit_registry, coverage_summary, format_audit)

TESTS_DIR = os.path.join(os.path.dirname(__file__), "..", "tests")


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--json-file", metavar="PATH", default=None,
                    help="also write the machine-readable report here "
                         "(the CI artifact)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when an op has no lower rule")
    ap.add_argument("--untested", action="store_true",
                    help="only show ops never referenced by a test file")
    ap.add_argument("--no-tests", action="store_true",
                    help="skip the test-reference scan")
    args = ap.parse_args(argv)

    test_dir = None if args.no_tests else os.path.abspath(TESTS_DIR)
    rows = audit_registry(test_dir=test_dir)
    if args.untested:
        rows = [r for r in rows if r["tested"] is False]
    missing_lower = [r["op"] for r in rows if not r["lower"]]
    report = {"ops": rows, "summary": coverage_summary(rows),
              "missing_lower": missing_lower,
              "status": "fail" if (missing_lower and args.strict) else "ok"}
    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        print(format_audit(rows))
    if args.json_file:
        with open(args.json_file, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, sort_keys=True)

    if missing_lower:
        print(f"\nops without a lower rule: {missing_lower}",
              file=sys.stderr)
        if args.strict:
            return 1
    return 0


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

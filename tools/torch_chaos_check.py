#!/usr/bin/env python
"""Chaos CI gate of the PyTorch port (``paddle_tpu_torch.resilience``;
counterpart of tools/chaos_check.py's single-chip gate, with its phases,
checks and report keys).

Proves, end to end with REAL process kills, that restart-after-failure is
a working path and not an accident:

1. **baseline** — a short deterministic training loop runs uninterrupted
   in a subprocess (beside phase 2, with which it shares nothing); final
   step / loss / param digest are recorded.
2. **kill mid-checkpoint** — the same loop runs under
   ``FLAGS_fault_plan="ckpt_write:@2:kill"``: the process is killed
   (``os._exit(137)``) inside the SECOND checkpoint write, after the
   blobs hit disk but before manifest + atomic rename. The gate asserts
   the live checkpoint dir holds only verified checkpoints plus a torn
   TEMP dir — the crash-safe write can not tear a published checkpoint.
3. **torn promotion** — the torn temp dir is renamed to
   ``checkpoint_<n>``, simulating a non-atomic writer dying mid-write.
4. **resume under compile faults** — the worker restarts in the same dir
   under ``FLAGS_fault_plan="compile:2:RuntimeError"``. It must: skip
   the torn checkpoint with a PT6xx diagnostic (reported, never loaded),
   resume from the last VERIFIED checkpoint, absorb both transient
   compile faults via retry/backoff (the port's compile event is the
   first run of an executor key), and finish with the exact final loss
   and param digest of the uninterrupted baseline.

Workers (``--model``):
  fc         the JAX tool's fc/SGD model: 30 steps, a checkpoint every 5,
             the kill inside serial 10's write, the resume from serial 5.
  bert_base  BERT-base f32 (batch 8, seq 128, dropout 0, Adam): 8 steps,
             a checkpoint every 2 (about 1.3 GB each), the kill inside
             serial 4's write, the resume from serial 2. Dropout is 0
             because the executor's step counter, which keys each step's
             random draws, is not checkpointed: a resumed run restarts it
             at 0. Each worker reports the K1/K3/K4 launches it made; on
             the card each must be > 0.

Usage:
  python tools/torch_chaos_check.py                 # phase table
  python tools/torch_chaos_check.py --check --json ci_chaos_report.json
      CI gate: exit 1 unless every phase assertion holds.
  python tools/torch_chaos_check.py --check --negative-control
      Kill + torn promotion as above, but the resume runs with retries
      DISABLED (FLAGS_retry_max_attempts=1) under a persistent compile
      fault plan: resume must fail and the gate must FAIL.
  --workdir DIR (default: a temp dir) holds the checkpoints; it is
  deleted at the end unless --keep-workdir. --tiny runs the bert_base
  worker at BERT-tiny width (a CPU rehearsal).

The JAX tool's --multichip and --elastic legs raise: they wait for the
port's multi-device slice (ROADMAP Queue A item 6). Runs on
``CUDAPlace(0)`` unless ``--device cpu`` (the workers get the same
device).
"""
from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

from tools import torch_gate_probes as probes  # noqa: E402

# (total steps, checkpoint every) of each worker model; the kill hits the
# 2nd checkpoint write and the resume starts from the one before
MODELS = {"fc": (30, 5), "bert_base": (8, 2)}
ATTENTION_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                     "flash_attention_dkv")


def _serials(model):
    steps, every = MODELS[model]
    kill = 2 * every
    return steps, every, kill, kill - every


# ---------------------------------------------------------------------------
# worker: one deterministic training run (invoked as a subprocess so a
# fault-plan `kill` takes out a real process, not the gate)
# ---------------------------------------------------------------------------

def _batch(step: int):
    import numpy as np

    rng = np.random.RandomState(1234 + step)
    w = np.arange(1, 5, dtype=np.float32).reshape(4, 1) / 4.0
    x = rng.rand(8, 4).astype(np.float32)
    return {"x": x, "y": (x @ w).astype(np.float32)}


def _fc_model():
    """(main, startup, loss, batch_fn) of the JAX tool's fc/SGD worker."""
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(x, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss, _batch


def _bert_model(seed, tiny=False):
    net, _, cfg = probes.bert_train(seed, tiny=tiny)

    def batch(step):
        return probes.bert_feed(1234 + step, cfg.vocab_size,
                                probes.BERT_BATCH, probes.BERT_SEQ)

    return net["main"], net["startup"], net["loss"], batch


def _digest_scope(scope):
    """sha256 over every scope var's name and bytes, in name order."""
    import numpy as np
    import torch

    digest = hashlib.sha256()
    for name in sorted(scope.vars):
        v = scope.find_var(name)
        digest.update(name.encode())
        if isinstance(v, torch.Tensor):
            digest.update(v.detach().reshape(-1).contiguous()
                          .view(torch.uint8).cpu().numpy().tobytes())
        else:
            digest.update(np.ascontiguousarray(np.asarray(v)).tobytes())
    return digest.hexdigest()


def _write_json(path, doc):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


def run_worker(args) -> int:
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch import monitor, resilience

    probes.set_device(args.device)
    if args.device == "cpu":
        import torch

        # the CPU's accumulating index_put_ (the embedding grads) adds
        # with atomics across threads: one thread repeats bit for bit, as
        # the card's sorted accumulation does
        torch.set_num_threads(1)
    main, startup, loss, batch = (_bert_model(args.seed, args.tiny)
                                  if args.model == "bert_base"
                                  else _fc_model())
    exe = probes.executor()
    scope = fluid.Scope()
    progress = args.result + ".progress"
    with fluid.scope_guard(scope):
        exe.run(startup)
        meta, serial, skipped = resilience.load_latest_checkpoint(
            exe, args.ckpt_dir, main_program=main, scope=scope)
        start = int(meta.get("step", 0)) if meta else 0
        final_loss = None
        for step in range(start, args.total_steps):
            (lv,) = exe.run(main, feed=batch(step), fetch_list=[loss])
            final_loss = float(np.asarray(lv).reshape(-1)[0])
            done = step + 1
            # the launches so far, on disk before a checkpoint write that
            # may be killed
            _write_json(progress, {"step": done,
                                   "launches": K.launch_counts()})
            if done % args.ckpt_every == 0:
                fluid.io.save_checkpoint(
                    exe, os.path.join(args.ckpt_dir, f"checkpoint_{done}"),
                    main, scope=scope, meta={"step": done})
    probes.synchronize()
    result = {
        "start_step": start,
        "resumed_from_serial": serial,
        "skipped_checkpoints": skipped,
        "final_step": args.total_steps,
        "final_loss": final_loss,
        "params_sha256": _digest_scope(scope),
        "retries": monitor.metric_value("resilience_retries_total",
                                        default=0.0, site="compile"),
        "giveups": monitor.metric_value("resilience_giveups_total",
                                        default=0.0, site="compile"),
        "fallbacks": len(skipped),
        "launches": K.launch_counts(),
    }
    _write_json(args.result, result)
    return 0


# ---------------------------------------------------------------------------
# parent: phase orchestration + gate
# ---------------------------------------------------------------------------

def _spawn(args, ckpt_dir: str, result: str, extra_env: dict):
    """Start one worker process: its ``Popen``."""
    steps, every, _, _ = _serials(args.model)
    env = dict(os.environ)
    # resilience/monitor flags leaking in from the caller's environment
    # would corrupt the phase semantics (FLAGS_monitor=0 would zero the
    # retry counters the gate asserts on) — each phase sets exactly the
    # flags it needs
    for leak in ("FLAGS_fault_plan", "FLAGS_fault_seed",
                 "FLAGS_retry_max_attempts", "FLAGS_retry_timeout",
                 "FLAGS_nan_inf_policy", "FLAGS_monitor"):
        env.pop(leak, None)
    env["FLAGS_retry_base_delay"] = "0.01"
    env.update(extra_env)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         "--ckpt-dir", ckpt_dir, "--result", result,
         "--total-steps", str(steps), "--ckpt-every", str(every),
         "--model", args.model, "--device", args.device,
         "--seed", str(args.seed)] + (["--tiny"] if args.tiny else []),
        env=env, cwd=REPO)


def _load(path: str):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _verifies(resilience, ckpt_dir: str, serial: int) -> bool:
    try:
        resilience.verify_checkpoint(
            os.path.join(ckpt_dir, f"checkpoint_{serial}"))
        return True
    except Exception:
        return False


def run_gate(args) -> int:
    from paddle_tpu_torch import resilience

    total, _, kill_serial, resume_serial = _serials(args.model)
    work = os.path.abspath(args.workdir)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work, exist_ok=True)
    checks = []          # (name, ok, detail)
    report = {"mode": "negative-control" if args.negative_control
              else "chaos", "model": args.model, "device": args.device,
              "phases": {}}
    # on the card the BERT-base workers must each have launched the
    # attention kernels (the CPU runs their plain versions)
    want_launches = args.model == "bert_base" and args.device == "cuda"

    def check(name, ok, detail=""):
        checks.append((name, bool(ok), detail))
        print(f"  [{'ok' if ok else 'MISS'}] {name}"
              + (f": {detail}" if detail else ""))

    def check_launches(phase, launches):
        if want_launches:
            got = {k: (launches or {}).get(k, 0) for k in ATTENTION_KERNELS}
            check(f"{phase}_launched_attention_kernels",
                  all(v > 0 for v in got.values()), str(got))

    try:
        # -- phase 1: uninterrupted baseline (skipped in negative
        # control: the control only needs to prove the gate trips on a
        # failed resume); it runs beside phase 2, which shares nothing
        # with it
        baseline = None
        if not args.negative_control:
            print("== phase 1: uninterrupted baseline (beside phase 2)")
            base_dir = os.path.join(work, "baseline_ckpts")
            baseline = _spawn(args, base_dir,
                              os.path.join(work, "baseline.json"), {})

        # -- phase 2: kill during the 2nd checkpoint write
        print(f"== phase 2: kill inside checkpoint_{kill_serial} write "
              f"(FLAGS_fault_plan=ckpt_write:@2:kill)")
        ckpt_dir = os.path.join(work, "chaos_ckpts")
        victim = os.path.join(work, "victim.json")
        rc = _spawn(args, ckpt_dir, victim,
                    {"FLAGS_fault_plan": "ckpt_write:@2:kill"}).wait()
        base = None
        if baseline is not None:
            base_rc = baseline.wait()
            # only the result is read: the baseline's checkpoints go
            shutil.rmtree(base_dir, ignore_errors=True)
            base = _load(os.path.join(work, "baseline.json"))
            check("baseline_clean", base_rc == 0 and base
                  and base["final_step"] == total, f"rc={base_rc}")
            report["phases"]["baseline"] = base
            check_launches("baseline", (base or {}).get("launches"))
        check("victim_killed", rc == 137, f"rc={rc} (137 = injected kill)")
        serials = [s for s, _ in resilience.iter_serials(ckpt_dir)]
        check("kill_left_only_verified_checkpoints",
              serials == [resume_serial] and _verifies(
                  resilience, ckpt_dir, resume_serial),
              f"published serials after kill: {serials}")
        torn_tmp = sorted(glob.glob(
            os.path.join(ckpt_dir, f".checkpoint_{kill_serial}.tmp.*")))
        check("torn_write_is_temp_dir", len(torn_tmp) == 1,
              f"temp dirs: {[os.path.basename(t) for t in torn_tmp]}")
        progress = _load(victim + ".progress") or {}
        report["phases"]["kill"] = {"rc": rc, "serials_after_kill": serials,
                                    "torn_tmp": torn_tmp,
                                    "launches": progress.get("launches")}
        check_launches("victim", progress.get("launches"))

        # -- phase 3: promote the torn temp dir to a live serial
        # (simulates a non-atomic writer dying mid-write)
        if torn_tmp:
            os.rename(torn_tmp[0],
                      os.path.join(ckpt_dir, f"checkpoint_{kill_serial}"))
            print(f"== phase 3: torn temp promoted to "
                  f"checkpoint_{kill_serial}")

        # -- phase 4: resume
        if args.negative_control:
            print("== phase 4 (negative control): resume with retries "
                  "DISABLED under a persistent compile fault")
            extra = {"FLAGS_fault_plan": "compile:99:RuntimeError",
                     "FLAGS_retry_max_attempts": "1"}
        else:
            print("== phase 4: resume under 2 transient compile faults "
                  "(FLAGS_fault_plan=compile:2:RuntimeError)")
            extra = {"FLAGS_fault_plan": "compile:2:RuntimeError"}
        rc = _spawn(args, ckpt_dir, os.path.join(work, "resume.json"),
                    extra).wait()
        res = _load(os.path.join(work, "resume.json"))
        report["phases"]["resume"] = {"rc": rc, "result": res}
        check("resume_completed", rc == 0 and res
              and res["final_step"] == total, f"rc={rc}")
        if res:
            check("resumed_from_last_verified",
                  res["resumed_from_serial"] == resume_serial,
                  f"resumed from {res['resumed_from_serial']}, want "
                  f"{resume_serial}")
            torn_reports = [s for s in res["skipped_checkpoints"]
                            if s["serial"] == kill_serial]
            check("torn_checkpoint_reported_not_loaded",
                  len(torn_reports) == 1 and str(
                      torn_reports[0]["code"]).startswith("PT6"),
                  f"skipped: {res['skipped_checkpoints']}")
            if not args.negative_control:
                check("transient_faults_absorbed",
                      res["retries"] == 2 and res["giveups"] == 0,
                      f"retries={res['retries']} giveups={res['giveups']}")
            check_launches("resume", res.get("launches"))
        if base and res:
            dl = abs(res["final_loss"] - base["final_loss"])
            check("final_loss_matches_uninterrupted_run",
                  res["final_loss"] == base["final_loss"],
                  f"|Δloss|={dl:.3g} at step {total} (bit-equal wanted)")
            check("final_params_bit_identical",
                  res["params_sha256"] == base["params_sha256"])
    finally:
        if not args.keep_workdir:
            shutil.rmtree(work, ignore_errors=True)

    ok = all(c[1] for c in checks)
    report["checks"] = [{"name": n, "ok": o, "detail": d}
                        for n, o, d in checks]
    report["status"] = "ok" if ok else "fail"
    print(f"chaos gate: {len([c for c in checks if c[1]])}/{len(checks)} "
          f"checks -> {'ok' if ok else 'FAIL'}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"chaos artifact written to {args.json}")
    return 0 if (not args.check or ok) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless every phase assertion holds")
    ap.add_argument("--json", metavar="PATH",
                    help="write the chaos report artifact as JSON")
    ap.add_argument("--negative-control", action="store_true",
                    help="resume with retries disabled — the gate must "
                         "FAIL (proves the tripwire trips)")
    ap.add_argument("--multichip", action="store_true",
                    help="the distributed leg (multi-device: raises)")
    ap.add_argument("--elastic", action="store_true",
                    help="the elastic leg (multi-device: raises)")
    ap.add_argument("--model", choices=sorted(MODELS), default="fc",
                    help="the worker: fc (the CPU gate's) or bert_base "
                         "(the card's)")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir for checkpoints/results (default: "
                         "a new temp dir)")
    ap.add_argument("--keep-workdir", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="the bert_base worker at BERT-tiny width (a CPU "
                         "rehearsal of the card's leg)")
    probes.add_device_arg(ap)
    # internal worker protocol
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-dir", help=argparse.SUPPRESS)
    ap.add_argument("--result", help=argparse.SUPPRESS)
    ap.add_argument("--total-steps", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-every", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.multichip:
        probes.refuse_multi_device("chaos_check --multichip")
    if args.elastic:
        probes.refuse_multi_device("chaos_check --elastic")
    if args.worker:
        return run_worker(args)
    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="torch_chaos_check_")
    return run_gate(args)


if __name__ == "__main__":
    sys.exit(main())

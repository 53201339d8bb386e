"""Fleet replica worker: one engine + one front-end as a process
(counterpart of ``paddle_tpu/serving/fleet/replica.py``, with its probes,
arguments and events).

``python -m paddle_tpu_torch.serving.fleet.replica --model mlp_tiny --port 0``
builds a model probe on ``CUDAPlace(0)`` (``--device cpu`` asks for the
CPU; with ``cuda`` and no card the replica fails, it never falls back),
initializes parameters, warms up every bucket (loading the prepared
executor steps from the warm-start cache when ``--aot-cache`` /
``FLAGS_aot_cache_dir`` points at one), starts the
HTTP front-end and the engine, installs the SIGTERM preemption handler,
and announces readiness as ONE JSON line on stdout::

    {"event": "ready", "replica_id": "r0", "port": 40913,
     "time_to_ready_s": 3.1, "warm_up_s": 1.4, "buckets": 4,
     "aot_cache": {"hits": 0, "misses": 4, "saves": 4, "errors": 0}}

``time_to_ready_s`` is measured from process entry (imports included —
what a fleet scheduler actually waits for); ``warm_up_s`` isolates the
preparation the warm-start cache removes. The parent (the router's
supervisor) reads the line, registers
the replica, and later SIGTERMs it: the preemption handler drains the
engine (every admitted request still reaches its typed outcome),
``/readyz`` flips 503 so the router routes away, the front-end finishes
writing in-flight responses, and the process prints an ``exit`` event
with its final accounting and exits 0.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def build_probe(name: str, config, device: str = "cuda"):
    """(engine, feed_meta) for one of the named model probes, on
    ``CUDAPlace(0)`` or, with ``device="cpu"``, the CPU. Feed
    construction stays in the wire's hands — the replica only needs the
    engine; ``feed_meta`` documents the expected feed for humans."""
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.unique_name as un
    from paddle_tpu_torch import serving

    if device not in ("cuda", "cpu"):
        raise SystemExit(f"unknown --device {device!r} (cuda or cpu)")
    exe = fluid.Executor(fluid.CPUPlace() if device == "cpu"
                         else fluid.CUDAPlace(0))
    scope = fluid.Scope()
    if name == "mlp_tiny":
        from paddle_tpu_torch.models.mlp import build_mnist_mlp

        with un.guard():
            net = build_mnist_mlp(hidden=(32,))
            infer = net["main"].clone(for_test=True)
        with fluid.scope_guard(scope):
            exe.run(net["startup"], scope=scope)
        eng = serving.ServingEngine(
            infer, feed_names=["img", "label"],
            fetch_list=[net["logits"].name], scope=scope, executor=exe,
            config=config)
        return eng, {"feeds": {"img": [784], "label": [1]}}
    if name == "resnet_tiny":
        from paddle_tpu_torch.models.resnet import build_resnet

        with un.guard():
            net = build_resnet(depth=18, class_num=10,
                               image_shape=(3, 16, 16),
                               build_optimizer=False)
            infer = net["main"].clone(for_test=True)
        with fluid.scope_guard(scope):
            exe.run(net["startup"], scope=scope)
        eng = serving.ServingEngine(
            infer, feed_names=["img", "label"],
            fetch_list=[net["logits"].name], scope=scope, executor=exe,
            config=config)
        return eng, {"feeds": {"img": [3, 16, 16], "label": [1]}}
    if name == "gpt_tiny":
        from paddle_tpu_torch.models.gpt import GptConfig, build_gpt_generative

        with un.guard():
            net = build_gpt_generative(GptConfig.tiny(), batch_slots=4,
                                       max_seq=32, page_size=8,
                                       prompt_buckets=(8, 16))
        with fluid.scope_guard(scope):
            exe.run(net["startup"], scope=scope)
        eng = serving.GenerativeEngine(
            net, scope=scope, executor=exe, config=config,
            gen_config=serving.GenerationConfig(decode_chunk=2))
        return eng, {"generative": True, "prompt_buckets": [8, 16]}
    raise SystemExit(f"unknown --model {name!r} "
                     f"(known: mlp_tiny, resnet_tiny, gpt_tiny)")


def main(argv=None) -> int:
    """Crash-safe entry: whatever kills the serve path, the ``exit``
    JSON event still ships on stdout (reason + best-effort final
    accounting) so the supervisor can CLASSIFY the failure from the
    event stream instead of guessing from the exit code alone. Only a
    real SIGKILL/`os._exit` (the ``kill`` fault action) leaves no event
    — which is itself the supervisor's 'kill' classification."""
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="mlp_tiny")
    ap.add_argument("--replica-id", default="r0")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--queue-depth", type=int, default=128)
    ap.add_argument("--queue-age-s", type=float, default=0.0)
    ap.add_argument("--batch-window-s", type=float, default=0.005)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine runs: CUDAPlace(0) (default) "
                         "or the CPU")
    ap.add_argument("--aot-cache", default="",
                    help="warm-start cache dir of prepared steps "
                         "(sets FLAGS_aot_cache_dir)")
    ap.add_argument("--trace", action="store_true",
                    help="enable FLAGS_trace so request roots join the "
                         "router's trace ids")
    ap.add_argument("--set-flag", action="append", default=[],
                    metavar="FLAGS_name=value",
                    help="set any framework flag in this replica "
                         "(repeatable) — how the chaos gate arms "
                         "per-replica fault plans, bisection and "
                         "nan checks")
    ap.add_argument("--crash-after-s", type=float, default=0.0,
                    help="chaos hook: raise a RuntimeError this many "
                         "seconds after ready (a REAL crash through the "
                         "crash-path exit event) — the supervisor gate's "
                         "deterministic crashing replica. 0 disables")
    ap.add_argument("--linger-s", type=float, default=2.0,
                    help="keep the front-end answering for this long "
                         "after the drain completes (clean 410 "
                         "rejections a router retries on a sibling, "
                         "instead of connections dying in the accept "
                         "backlog at process exit)")
    args = ap.parse_args(argv)
    state: dict = {}
    try:
        return _serve(args, t_start, state)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:
        import traceback

        traceback.print_exc()
        info = {"event": "exit", "replica_id": args.replica_id,
                "reason": "crash", "error": f"{type(e).__name__}: {e}"}
        try:
            eng = state.get("engine")
            if eng is not None:
                info["accounting"] = eng.accounting()
        except Exception:
            pass
        print(json.dumps(info), flush=True)
        return 21


def _serve(args, t_start: float, state: dict) -> int:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import aot_cache, serving
    from paddle_tpu_torch.serving.fleet import ServingFrontend

    flags = {}
    if args.aot_cache:
        flags["FLAGS_aot_cache_dir"] = args.aot_cache
    if args.trace:
        flags["FLAGS_trace"] = 1
    for kv in args.set_flag:
        if "=" not in kv:
            raise SystemExit(f"--set-flag needs FLAGS_name=value, "
                             f"got {kv!r}")
        k, v = kv.split("=", 1)
        flags[k] = v
    if flags:
        fluid.set_flags(flags)

    config = serving.ServingConfig(
        max_batch=args.max_batch, queue_depth=args.queue_depth,
        queue_age_s=args.queue_age_s, batch_window_s=args.batch_window_s)
    eng, meta = build_probe(args.model, config, args.device)
    state["engine"] = eng

    t0 = time.perf_counter()
    buckets = eng.warm_up()
    warm_up_s = time.perf_counter() - t0
    cache = aot_cache.cache_stats()

    # fleet-shared autotuning visibility: how many warm-up lookups hit
    # the shared CostDatabase vs re-measured
    from paddle_tpu_torch import monitor, tuning
    autotune = {"mode": tuning.autotune_mode(),
                "hits": int(monitor.metric_value(
                    "autotune_hits_total", 0.0)),
                "misses": int(monitor.metric_value(
                    "autotune_misses_total", 0.0)),
                "trials": int(monitor.metric_value(
                    "autotune_trials_total", 0.0))}

    startup = {"model": args.model, "warm_up_s": warm_up_s,
               "buckets": buckets, "aot_cache": cache,
               "autotune": autotune,
               "time_to_ready_s": time.perf_counter() - t_start}
    frontend = ServingFrontend(eng, host=args.host, port=args.port,
                               replica_id=args.replica_id,
                               extra_health=startup)
    port = frontend.start()
    eng.start()
    eng.install_preemption_handler()
    startup["time_to_ready_s"] = time.perf_counter() - t_start
    # the front-end holds its own copy of extra_health: refresh it so
    # /healthz's "startup" agrees with the ready event below
    frontend.extra_health.update(startup)

    print(json.dumps({"event": "ready", "replica_id": args.replica_id,
                      "model": args.model, "port": port, **startup}),
          flush=True)

    # serve until the preemption handler (SIGTERM / request_shutdown)
    # drain-stops the engine; stop() runs on the graceful callback
    # thread and returns only after the dispatch thread exits, so
    # "stopped and dispatch thread dead" == drain complete
    crash_at = (time.monotonic() + args.crash_after_s
                if args.crash_after_s > 0 else None)
    try:
        while True:
            time.sleep(0.1)
            if crash_at is not None and time.monotonic() >= crash_at:
                # the chaos hook: a genuine exception through the
                # crash-path handler, exit event included
                raise RuntimeError(
                    f"injected replica crash (--crash-after-s "
                    f"{args.crash_after_s:g})")
            if eng._stopped and (eng._thread is None
                                 or not eng._thread.is_alive()):
                break
    except KeyboardInterrupt:
        eng.stop(drain=True)

    # drain complete — but a router whose pressure snapshot predates the
    # drain may still be dispatching here. Linger with the front-end up:
    # those dispatches meet a clean 410 (admitted=false, safely retried
    # on a sibling) instead of a connection that dies in the accept
    # backlog when this process exits — which the router must settle as
    # ReplicaLost (possibly admitted, never retryable).
    if args.linger_s > 0:
        time.sleep(args.linger_s)

    acct = eng.accounting()
    frontend.stop(wait_inflight_s=10.0)
    print(json.dumps({"event": "exit", "replica_id": args.replica_id,
                      "reason": "drain", "accounting": acct}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

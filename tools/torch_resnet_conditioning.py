"""How well conditioned a few ResNet-18 train steps are, on the CPU: the
measurement behind the configuration of ``tests/test_torch_resnet.py``.

    JAX_PLATFORMS=cpu python3 tools/torch_resnet_conditioning.py \\
        [--configs 0.1:32:4,0.1:64:4,0.01:64:4,0.01:64:4:amp,0.01:64:8:amp]
        [--steps 3]

For each configuration ``lr:image:batch[:amp]`` (ResNet-18, 10 classes,
Momentum mu 0.9, a random batch from a fixed seed, the JAX package's
initial weights carried into the port with ``interop.scope_from_numpy``)
it runs ``--steps`` steps three ways: the JAX package; the JAX package
again with the input images scaled by (1 + 1e-7), which shows how far
rounding alone moves the run; and the port. It prints the losses and,
per step, the relative loss difference of the perturbed run and of the
port from the JAX package, the largest difference of the step-1 logits
relative to their largest value, and the port's largest state difference
(parameters, velocities, running stats) after the steps. CPU numbers:
they measure arithmetic, not speed.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import paddle_tpu as jfluid  # noqa: E402
import paddle_tpu.unique_name as jun  # noqa: E402
from paddle_tpu.models.resnet import build_resnet as j_build  # noqa: E402

import paddle_tpu_torch as tfluid  # noqa: E402
import paddle_tpu_torch.unique_name as tun  # noqa: E402
from paddle_tpu_torch.interop import scope_from_numpy  # noqa: E402
from paddle_tpu_torch.models.resnet import build_resnet as t_build  # noqa: E402


def run(lr, hw, batch, amp, steps):
    kw = dict(depth=18, class_num=10, image_shape=(3, hw, hw), lr=lr,
              amp=amp)
    with jun.guard():
        j = j_build(**kw)
    with tun.guard():
        t = t_build(**kw)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(batch, 3, hw, hw).astype(np.float32),
            "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}
    names = [v.name for v in j["startup"].global_block.vars.values()]
    fetch = [j["loss"].name, j["logits"].name]
    out = {}
    for way in ("jax", "perturbed", "port"):
        jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        jexe.run(j["startup"], scope=jscope)
        f = dict(feed)
        if way == "port":
            exe = tfluid.Executor(tfluid.CPUPlace())
            scope = scope_from_numpy({n: jscope.numpy(n) for n in names},
                                     tfluid.Scope(), tfluid.CPUPlace(),
                                     programs=[t["main"]])
            prog = t["main"]
        else:
            exe, scope, prog = jexe, jscope, j["main"]
            if way == "perturbed":
                f["img"] = feed["img"] * np.float32(1 + 1e-7)
        losses, logits = [], None
        for step in range(steps):
            loss, lg = exe.run(prog, feed=f, fetch_list=fetch, scope=scope)
            losses.append(float(np.ravel(loss)[0]))
            if step == 0:
                logits = np.asarray(lg, np.float32)
        out[way] = (np.array(losses), logits,
                    {n: np.asarray(scope.numpy(n), np.float64)
                     for n in names})
    ref_l, ref_lg, ref_s = out["jax"]
    sci = {"float_kind": lambda v: f"{v:.2e}"}
    print(f"lr {lr}, {hw}x{hw}, batch {batch}, {'bf16' if amp else 'f32'}: "
          f"JAX losses {np.array2string(ref_l, formatter=sci)}")
    for way in ("perturbed", "port"):
        l, lg, st = out[way]
        rel = np.abs(l - ref_l) / np.abs(ref_l)
        lg_rel = np.abs(lg - ref_lg).max() / np.abs(ref_lg).max()
        state = max(np.abs(st[n] - ref_s[n]).max() for n in names)
        print(f"  {way:9s} loss rel diff by step "
              f"{np.array2string(rel, formatter=sci)}; step-1 logits "
              f"{lg_rel:.2e} of their largest; state max abs diff "
              f"{state:.2e}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs",
                    default="0.1:32:4,0.1:64:4,0.01:64:4,0.01:64:4:amp,"
                            "0.01:64:8:amp")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    for cfg in args.configs.split(","):
        parts = cfg.split(":")
        run(float(parts[0]), int(parts[1]), int(parts[2]),
            len(parts) > 3 and parts[3] == "amp", args.steps)


if __name__ == "__main__":
    main()

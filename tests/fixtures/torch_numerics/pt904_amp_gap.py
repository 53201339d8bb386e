"""PT904 positive control: loss-scale coverage gap.

A training program where ``check_finite_and_unscale`` is spliced over
ONE parameter gradient while the others reach their SGD updates raw —
those updates apply gradients still multiplied by the loss-scale factor.
The analysis must report PT904 for every uncovered grad.
"""
import paddle_tpu_torch as fluid


EXPECTED = "PT904"


def build():
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 8, act="relu")
        p = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square(p - y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        blk = main.global_block
        grads = sorted(n for n in blk.vars
                       if n.endswith("@GRAD") and ".w_" in n)
        scale = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                           value=128.0)
        found = blk.create_var(name="found_inf", shape=(1,), dtype="bool")
        # unscale covers only the first weight grad; the rest reach the
        # sgd ops raw -> PT904 per uncovered grad
        blk.append_op("check_finite_and_unscale",
                      inputs={"X": [grads[0]], "Scale": [scale.name]},
                      outputs={"Out": [grads[0]],
                               "FoundInfinite": [found.name]})
    return main, startup, [loss.name]

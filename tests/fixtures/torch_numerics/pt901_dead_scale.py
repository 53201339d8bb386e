"""PT901 positive control: non-persistable moving-average scale state.

A properly QAT-rewritten training program (``quant_aware`` before
``minimize``, the documented order) whose moving-average activation
scale vars are then flipped to ``persistable=False`` — the running scale
would reset every step and the calibration never converges. The analysis
must report PT901 for each such scale.
"""
import paddle_tpu_torch as fluid
from paddle_tpu_torch.contrib.slim.quantization import quant_aware


EXPECTED = "PT901"


def build():
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 8, act="relu")
        p = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square(p - y))
        quant_aware(main, startup)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    # break the state contract: moving-average scales must persist
    for v in main.global_block.vars.values():
        if ".quant_scale" in v.name and v.persistable:
            v.persistable = False
    return main, startup, [loss.name]

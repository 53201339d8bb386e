"""PT905 positive control: domain hazards on statically-proven intervals.

``log`` of an exactly-negative constant and a division whose denominator
interval provably contains 0 — both produce inf/nan with no guard in
sight. The analysis must report PT905. (The companion negative case — the
same ops behind ``clip``/``abs`` guards — lives in tests/test_numerics.py:
guards narrow the interval and must clear the finding.)
"""
import paddle_tpu_torch as fluid


EXPECTED = "PT905"


def build():
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        c = fluid.layers.fill_constant(shape=[4], dtype="float32",
                                       value=-1.0)
        bad_log = fluid.layers.log(c)           # log of [-1, -1] -> PT905
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        den = fluid.layers.tanh(x)              # [-1, 1] contains 0
        q = fluid.layers.elementwise_div(x, den)  # PT905
        out = fluid.layers.mean(q + bad_log)
    return main, startup, [out.name]

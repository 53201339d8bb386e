"""PT903 positive control: reduction accumulated in storage precision.

A float16 tensor reduced by ``reduce_sum`` into a float16 output — every
partial sum rounds to float16 (vs the float32-accumulate idiom). The
analysis must report PT903.
"""
import paddle_tpu_torch as fluid


EXPECTED = "PT903"


def build():
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[1024], dtype="float32")
        h = fluid.layers.cast(x, "float16")
        s = fluid.layers.reduce_sum(h)          # fp16 -> fp16 accumulate
        out = fluid.layers.cast(s, "float32")
    return main, startup, [out.name]

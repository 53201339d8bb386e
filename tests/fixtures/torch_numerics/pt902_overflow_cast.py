"""PT902 positive control: cast whose proven interval overflows the
target dtype.

``fill_constant(1e6)`` has the exact interval [1e6, 1e6]; float16's
finite range tops out at 65504, so the cast is a statically-proven
overflow to inf. The analysis must report PT902.
"""
import paddle_tpu_torch as fluid


EXPECTED = "PT902"


def build():
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        c = fluid.layers.fill_constant(shape=[4], dtype="float32",
                                       value=1.0e6)
        h = fluid.layers.cast(c, "float16")     # 1e6 > 65504 -> PT902
        out = fluid.layers.cast(h, "float32")
    return main, startup, [out.name]

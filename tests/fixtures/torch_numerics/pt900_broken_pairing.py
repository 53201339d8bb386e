"""PT900 positive control: fake-quant output consumed off the GEMM path.

A hand-spliced ``fake_quantize_dequantize_abs_max`` feeds ``relu`` —
a consumer the int8 rewrite cannot reproduce (the dequantized values
would differ from the int8 kernel's). A second fake-quant output is never
consumed at all (dead quantization). Both shapes of broken pairing must
report PT900.
"""
import paddle_tpu_torch as fluid


EXPECTED = "PT900"


def build():
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        blk = main.global_block
        q = blk.create_var(name="x.quantized", shape=x.shape,
                           dtype="float32")
        s = blk.create_var(name="x.quant_scale", shape=(1,),
                           dtype="float32")
        blk.append_op("fake_quantize_dequantize_abs_max",
                      inputs={"X": [x.name]},
                      outputs={"Out": [q.name], "OutScale": [s.name]},
                      attrs={"bit_length": 8})
        out = fluid.layers.relu(q)          # off-path consumer -> PT900
        # dead fake-quant: output never consumed, never fetched -> PT900
        q2 = blk.create_var(name="x.quantized_dead", shape=x.shape,
                            dtype="float32")
        s2 = blk.create_var(name="x.quant_scale_dead", shape=(1,),
                            dtype="float32")
        blk.append_op("fake_quantize_dequantize_abs_max",
                      inputs={"X": [x.name]},
                      outputs={"Out": [q2.name], "OutScale": [s2.name]},
                      attrs={"bit_length": 8})
    return main, startup, [out.name]

"""Knowledge distillation (counterpart of
``paddle_tpu/contrib/slim/distillation``; reference
contrib/slim/distillation/distiller.py: L2Distiller :25, FSPDistiller :103,
SoftLabelDistiller :195).

The reference's GraphWrapper machinery merged teacher and student programs
into one IR graph and spliced loss ops in C++-adjacent passes. Here the
same result is two plain program transforms:

- ``merge_teacher_program``: append the teacher's ops/params into the
  student's program under a name prefix (teacher params load under their
  prefixed names and are frozen via stop_gradient) — one program runs
  both networks in one executor step.
- distillers: functions appending the distillation loss ops to the merged
  program and returning the loss Variable, mirroring the reference's
  distiller_loss contract.
"""
from __future__ import annotations

from ....framework import default_main_program, program_guard

__all__ = ["merge_teacher_program", "L2Distiller", "FSPDistiller",
           "SoftLabelDistiller", "fsp_matrix"]


def merge_teacher_program(student_program, teacher_program,
                          prefix="teacher_", feed_map=None,
                          teacher_startup=None, student_startup=None):
    """Append the teacher's global-block ops and vars into the student
    program, renaming every teacher var ``prefix + name``. ``feed_map``
    maps teacher feed names -> student var names so both nets read the
    same input batch. Teacher vars are created stop_gradient=True (frozen
    teacher — reference distillation_strategy.py on_compression_begin).
    When startup programs are given, the teacher's initializer ops merge
    into the student's startup under the same renames, so one
    ``exe.run(startup)`` initializes both nets (load real teacher weights
    over them afterwards with io.load_params).
    Returns {original teacher var name -> merged name}."""
    feed_map = feed_map or {}
    renames = {}

    def merge_block(src_block, dst_block):
        for name, v in src_block.vars.items():
            if name in feed_map:
                renames[name] = feed_map[name]
                continue
            new_name = prefix + name
            renames.setdefault(name, new_name)
            if dst_block.has_var(new_name):
                continue
            if type(v).__name__ == "Parameter":
                # must stay a Parameter: io.save/load_params filters on the
                # class, so plain vars would be silently skipped when
                # loading real teacher weights — but frozen (the teacher
                # never trains here)
                nv = dst_block.create_parameter(
                    new_name, v.shape, v.dtype, trainable=False)
                nv.persistable = True
                nv.stop_gradient = True
            else:
                nv = dst_block.create_var(
                    name=new_name, shape=v.shape, dtype=v.dtype,
                    persistable=v.persistable, stop_gradient=True,
                    is_data=getattr(v, "is_data", False))
            nv.lod_level = getattr(v, "lod_level", 0)
        for op in src_block.ops:
            if op.type in ("feed", "fetch"):
                continue
            inputs = {slot: [renames.get(n, n) for n in names]
                      for slot, names in op.inputs.items()}
            outputs = {slot: [renames.get(n, n) for n in names]
                       for slot, names in op.outputs.items()}
            dst_block.append_op(op.type, inputs=inputs, outputs=outputs,
                                attrs=dict(op.attrs))

    merge_block(teacher_program.global_block, student_program.global_block)
    if teacher_startup is not None and student_startup is not None:
        merge_block(teacher_startup.global_block,
                    student_startup.global_block)
    return renames


class L2Distiller:
    """||student_fmap - teacher_fmap||^2 (reference distiller.py:25)."""

    def __init__(self, student_feature_map, teacher_feature_map,
                 distillation_loss_weight=1.0):
        self.student_feature_map = student_feature_map
        self.teacher_feature_map = teacher_feature_map
        self.weight = distillation_loss_weight

    def distiller_loss(self, program=None):
        from ....layers import nn as L

        program = program or default_main_program()
        blk = program.global_block
        with program_guard(program):  # loss ops must land in THIS program
            s = blk.var(self.student_feature_map)
            t = blk.var(self.teacher_feature_map)
            diff = L.elementwise_sub(s, t)
            loss = L.reduce_mean(L.square(diff))
            return L.scale(loss, scale=float(self.weight))


def fsp_matrix(a, b):
    """Flow-of-solution-procedure matrix (reference distiller.py:191):
    for feature maps [N, C1, H, W] and [N, C2, H, W],
    fsp = a_flat @ b_flat^T / (H*W) -> [N, C1, C2]."""
    from ....layers import nn as L

    n, c1 = a.shape[0], a.shape[1]
    c2 = b.shape[1]
    hw = int(a.shape[2]) * int(a.shape[3])
    a2 = L.reshape(a, [-1, c1, hw])
    b2 = L.reshape(b, [-1, c2, hw])
    prod = L.matmul(a2, L.transpose(b2, [0, 2, 1]))
    return L.scale(prod, scale=1.0 / hw)


class FSPDistiller:
    """FSP-matrix distillation (reference distiller.py:103): match the
    student's and teacher's layer-pair flow matrices by l2."""

    def __init__(self, student_pairs, teacher_pairs,
                 distillation_loss_weight=1.0):
        self.student_pairs = student_pairs
        self.teacher_pairs = teacher_pairs
        self.weight = distillation_loss_weight

    def distiller_loss(self, program=None):
        from ....layers import nn as L

        program = program or default_main_program()
        blk = program.global_block
        with program_guard(program):
            losses = []
            for (s0, s1), (t0, t1) in zip(self.student_pairs,
                                          self.teacher_pairs):
                sf = fsp_matrix(blk.var(s0), blk.var(s1))
                tf = fsp_matrix(blk.var(t0), blk.var(t1))
                losses.append(L.reduce_mean(L.square(
                    L.elementwise_sub(sf, tf))))
            total = losses[0]
            for extra in losses[1:]:
                total = L.elementwise_add(total, extra)
            return L.scale(total, scale=float(self.weight))


class SoftLabelDistiller:
    """Soft-target cross entropy with temperatures (reference
    distiller.py:195): CE(softmax(t/T_t), softmax(s/T_s))."""

    def __init__(self, student_feature_map, teacher_feature_map,
                 student_temperature=1.0, teacher_temperature=1.0,
                 distillation_loss_weight=1.0):
        self.student_feature_map = student_feature_map
        self.teacher_feature_map = teacher_feature_map
        self.student_temperature = student_temperature
        self.teacher_temperature = teacher_temperature
        self.weight = distillation_loss_weight

    def distiller_loss(self, program=None):
        from ....layers import nn as L

        program = program or default_main_program()
        blk = program.global_block
        with program_guard(program):
            s = L.scale(blk.var(self.student_feature_map),
                        scale=1.0 / self.student_temperature)
            t = L.scale(blk.var(self.teacher_feature_map),
                        scale=1.0 / self.teacher_temperature)
            s_log_prob = L.log_softmax(s)
            t_prob = L.softmax(t)
            ce = L.reduce_mean(
                L.reduce_sum(L.elementwise_mul(
                    L.scale(t_prob, scale=-1.0), s_log_prob), dim=-1))
            return L.scale(ce, scale=float(self.weight))

"""Broken-program fixtures for the port's numerics linter's negative
control (copies of ``tests/fixtures/numerics`` over ``paddle_tpu_torch``).

One module per PT90x code. Each defines ``EXPECTED`` (the code it must
trip) and ``build()`` returning ``(main_program, startup_program,
fetch_names)``. ``tools/torch_lint_numerics.py --negative-control`` loads
every module here, runs ``analysis.numerics.analyze_numerics`` over the
built program and exits non-zero unless EVERY code fires — a control
that cannot trip a family proves that family's detector is broken, so a
missing code is exit 2, not a pass.
"""
FIXTURE_MODULES = (
    "pt900_broken_pairing",
    "pt901_dead_scale",
    "pt902_overflow_cast",
    "pt903_low_precision_reduce",
    "pt904_amp_gap",
    "pt905_nonfinite",
)

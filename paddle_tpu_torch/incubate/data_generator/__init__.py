"""DataGenerator — the MultiSlot training-data writer of the PyTorch port,
a copy of ``paddle_tpu/incubate/data_generator`` (reference
python/paddle/fluid/incubate/data_generator/__init__.py:21).

Role: users subclass it to turn raw text lines into the space-separated
``<ids_num> id1 id2 ...`` MultiSlot format that DatasetFactory / the
port's ``native/datafeed.cpp`` ingest, either streaming (stdin -> stdout,
the MR pipeline pattern) or from memory. Semantics mirror the reference: a float
feasign upgrades the slot's recorded type, batch mode buffers
``batch_size`` samples through ``generate_batch``.
"""
from __future__ import annotations

import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    """Base class (reference data_generator/__init__.py:21)."""

    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 1
        self._line_limit = None

    def _set_line_limit(self, line_limit):
        if not isinstance(line_limit, int) or line_limit < 1:
            raise ValueError("line_limit must be a positive int")
        self._line_limit = line_limit

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def run_from_memory(self):
        """Generate data from memory: process samples yielded by
        ``generate_sample(None)``, batched through ``generate_batch``,
        write MultiSlot lines to stdout (reference :67)."""
        batch_samples = []
        line_iter = self.generate_sample(None)
        for user_parsed_line in line_iter():
            if user_parsed_line is None:
                continue
            batch_samples.append(user_parsed_line)
            if len(batch_samples) == self.batch_size_:
                batch_iter = self.generate_batch(batch_samples)
                for sample in batch_iter():
                    sys.stdout.write(self._gen_str(sample))
                batch_samples = []
        if batch_samples:
            batch_iter = self.generate_batch(batch_samples)
            for sample in batch_iter():
                sys.stdout.write(self._gen_str(sample))

    def run_from_stdin(self):
        """Process each stdin line through ``generate_sample`` (reference
        :101) — the Hadoop-streaming-style entry point."""
        batch_samples = []
        processed = 0
        for line in sys.stdin:
            if self._line_limit and processed >= self._line_limit:
                break
            processed += 1
            line_iter = self.generate_sample(line)
            for user_parsed_line in line_iter():
                if user_parsed_line is None:
                    continue
                batch_samples.append(user_parsed_line)
                if len(batch_samples) == self.batch_size_:
                    batch_iter = self.generate_batch(batch_samples)
                    for sample in batch_iter():
                        sys.stdout.write(self._gen_str(sample))
                    batch_samples = []
        if batch_samples:
            batch_iter = self.generate_batch(batch_samples)
            for sample in batch_iter():
                sys.stdout.write(self._gen_str(sample))

    def _gen_str(self, line):
        raise NotImplementedError(
            "use MultiSlotDataGenerator or MultiSlotStringDataGenerator")

    def generate_sample(self, line):
        raise NotImplementedError(
            "rewrite generate_sample to return a zero-arg generator "
            "yielding [(name, [feasign, ...]), ...]")

    def generate_batch(self, samples):
        def local_iter():
            for sample in samples:
                yield sample

        return local_iter


class MultiSlotDataGenerator(DataGenerator):
    """Writes ``<num> id...`` per slot; tracks per-slot types the way the
    reference does — a float feasign upgrades the slot from uint64 to
    float (reference :282 _gen_str)."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of process() must be in list or tuple type; "
                "example: [('words', [1926, 8, 17]), ('label', [1])]")
        out = []
        if self._proto_info is None:
            self._proto_info = []
            first = True
        else:
            first = False
            if len(line) != len(self._proto_info):
                raise ValueError(
                    f"the complete field set of two samples must be the "
                    f"same: got {len(line)} slots, expected "
                    f"{len(self._proto_info)}")
        for i, item in enumerate(line):
            name, elements = item
            if not isinstance(name, str):
                raise ValueError(f"name {type(name)} must be str")
            if not isinstance(elements, list):
                raise ValueError(f"elements {type(elements)} must be list")
            if not elements:
                raise ValueError(
                    f"slot {name!r} is empty — pad it in process()")
            if first:
                self._proto_info.append((name, "uint64"))
            else:
                if name != self._proto_info[i][0]:
                    raise ValueError(
                        f"the field name of two samples must match: "
                        f"{name} != {self._proto_info[i][0]}")
            out.append(str(len(elements)))
            for elem in elements:
                if isinstance(elem, bool):
                    # bool IS an int subclass — str() would emit the
                    # literal 'True' and corrupt the MultiSlot line
                    elem = int(elem)
                elif isinstance(elem, float):
                    self._proto_info[i] = (name, "float")
                elif not isinstance(elem, int):
                    raise ValueError(
                        f"the type of element {type(elem)} must be "
                        f"int or float")
                out.append(str(elem))
        return " ".join(out) + "\n"


class MultiSlotStringDataGenerator(DataGenerator):
    """String feasigns passthrough (later-reference variant): elements are
    written verbatim, no type tracking."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of process() must be in list or tuple type")
        out = []
        for name, elements in line:
            out.append(str(len(elements)))
            out.extend(str(e) for e in elements)
        return " ".join(out) + "\n"

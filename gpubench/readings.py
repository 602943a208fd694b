#!/usr/bin/env python3
"""The readings that a cell's limits of ``correct`` are set from.

    python3 gpubench/readings.py --workload <cell> --seeds 11,12,... \
        [--control 3] [--faults 3] [--out FILE]

For each seed: the cell's inputs and one call of the cell's entry with the
cell's arguments (the timed path at the timed sizes), judged by the cell's
entry module (``gpubench/entries/<entry>.py``) as a run judges it. On the
first ``--control`` seeds also the entry module's ``control`` (for
fastMNN, the reference put in the program's place one precision below
what the configuration states: TF32 products, the MNN searches' selection
in fp8 where the traffic states bf16), judged the same way; on the first
``--faults`` seeds the program with each of the entry module's ``FAULTS``
planted. One JSON line per reading; the last line gives, per number, the
largest sound reading, the smallest control reading and each fault's
smallest reading. Needs a card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import batchelor_torch as bt
    from gpubench import harness

    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cell = harness.load_cell(args.workload)
    mod = cell.entry
    for flag, needs in ((args.control, "control"), (args.faults, "planted")):
        if flag and not hasattr(mod, needs):
            print(f"readings: the entry module {mod.__file__} has no {needs}", file=sys.stderr)
            return 2
    entry = getattr(bt, cell.traffic["entry"])
    kwargs = dict(harness.call_args(cell), device=dev)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    sound, control, planted = {}, {}, {}

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    def fold(table, key, values, pick):
        for k, v in values.items():
            table.setdefault(key, {})
            table[key][k] = v if k not in table[key] else pick(table[key][k], v)

    def read(side, out, inputs):
        return mod.judge(cell, {side: out}, inputs)[1]

    for i, seed in enumerate(seeds):
        inputs = mod.make_inputs(cell, seed, dev)
        t = time.perf_counter()
        out = mod.output(entry(inputs, **kwargs))
        call_s = time.perf_counter() - t
        t = time.perf_counter()
        values = read("program", out, inputs)
        ref_s = time.perf_counter() - t
        emit({"workload": cell.name, "seed": seed, "side": "program", "call_s": call_s,
              "reference_s": ref_s, "readings": values})
        fold(sound, "program", values, max)
        del out
        if i < args.control:
            t = time.perf_counter()
            values = read("control", mod.control(cell, inputs), inputs)
            emit({"workload": cell.name, "seed": seed, "side": "control",
                  "control_s": time.perf_counter() - t, "readings": values})
            fold(control, "control", values, min)
        if i < args.faults:
            for name in mod.FAULTS:
                with mod.planted(name):
                    out = mod.output(entry(inputs, **kwargs))
                values = read(f"fault:{name}", out, inputs)
                emit({"workload": cell.name, "seed": seed, "side": f"fault:{name}",
                      "readings": values})
                fold(planted, name, values, min)
                del out
        del inputs
        torch.cuda.empty_cache()
    emit({"workload": cell.name, "summary": {"program_max": sound.get("program", {}),
                                             "control_min": control.get("control", {}),
                                             "faults_min": planted},
          "limits": cell.limits,
          "card": torch.cuda.get_device_name(0)})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

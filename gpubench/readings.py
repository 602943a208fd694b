#!/usr/bin/env python3
"""The readings that a cell's limits of ``correct`` are set from.

    python3 gpubench/readings.py --workload <cell> --seeds 11,12,... \
        [--control 3] [--faults 3] [--out FILE]

For each seed: the cell's batches, one call of the cell's entry with the
cell's arguments (the timed path at the timed sizes), the plain reference
(float64) following the call's pairs, and the program's numbers against
it, with ``own_rows_err_p50`` against the reference's own merge, which
chose its pairs itself. On the first ``--control``
seeds also the control, the reference put in the program's place one
precision below what the configuration states (TF32 products; the MNN
searches' selection in fp8 where the traffic states bf16), against the
reference; on the first ``--faults`` seeds the program with each fault of
``gpubench/faults.py`` planted. One JSON line per reading; the last line
gives, per number, the largest sound reading, the smallest control
reading and each fault's smallest reading. Needs a card.
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
    from gpubench import compare, faults, generator, harness

    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cell = harness.load_cell(args.workload)
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

    for i, seed in enumerate(seeds):
        inputs = generator.make_batches(cell.config, cell.traffic["input"], seed, dev)
        t = time.perf_counter()
        out = harness.program_output(entry(inputs, **kwargs))
        call_s = time.perf_counter() - t
        t = time.perf_counter()
        own, ref = harness.reference_outputs(cell, inputs, [None, out["pairs"]])
        ref_s = time.perf_counter() - t
        values = {**compare.readings(out, ref), **compare.own_readings(out, own)}
        emit({"workload": cell.name, "seed": seed, "side": "program", "call_s": call_s,
              "reference_s": ref_s, "readings": values})
        fold(sound, "program", values, max)
        del out
        if i < args.control:
            t = time.perf_counter()
            ctl = harness.reference_outputs(cell, inputs, [None], "tf32",
                                            harness.control_selection(cell))[0]
            values = {**compare.readings(
                ctl, harness.reference_outputs(cell, inputs, [ctl["pairs"]])[0]),
                **compare.own_readings(ctl, own)}
            emit({"workload": cell.name, "seed": seed, "side": "control",
                  "control_s": time.perf_counter() - t, "readings": values})
            fold(control, "control", values, min)
            del ctl
        if i < args.faults:
            for name in faults.FAULTS:
                with faults.planted(name):
                    out = harness.program_output(entry(inputs, **kwargs))
                values = {**compare.readings(
                    out, harness.reference_outputs(cell, inputs, [out["pairs"]])[0]),
                    **compare.own_readings(out, own)}
                emit({"workload": cell.name, "seed": seed, "side": f"fault:{name}",
                      "readings": values})
                fold(planted, name, values, min)
                del out
        del inputs, ref, own
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

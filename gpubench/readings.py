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
smallest reading. A seed's rows give ``control_s``, the control's own
merge, and ``reference_s``, the judgement of every side of the seed: where
the entry module has ``output_readings``, one reference for them all.
Needs a card, or as many as the cell asks for.

A cell on n > 1 cards runs as n ranks, as ``run.py`` runs it
(``gpubench/ranks.py``): every rank makes each seed's inputs, makes each
call and plants each fault, and the judgements of a round of n seeds are
shared out, seed i to rank i mod n, each on its own card, so that n seeds
are judged at once; rank 0 prints every reading.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# a rank may judge a round's seeds for many minutes while the others wait
JUDGE_TIMEOUT_S = 3600


def _argv(cell, seeds, n_control: int, n_faults: int) -> list:
    return ["--workload", cell.name, "--seeds", ",".join(str(s) for s in seeds),
            "--control", str(n_control), "--faults", str(n_faults)]


def read_cell(cell, bt, seeds, n_control: int, n_faults: int, device, emit) -> dict:
    """Rank 0's readings of ``cell`` on ``device``: each reading handed to
    ``emit`` as a dict, in seed order; returns the summary. Starts and
    ends the other ranks of a cell on several cards."""
    import torch

    from gpubench import ranks

    world = ranks.World.start(Path(__file__).resolve(), _argv(cell, seeds, n_control, n_faults),
                              cell.chips, cell.root, torch.device(device).type)
    try:
        summary = read_rounds(cell, bt, seeds, n_control, n_faults, world,
                              world.device(device), emit)
        world.close()
    except BaseException:
        world.abort()
        raise
    return summary


def read_rounds(cell, bt, seeds, n_control, n_faults, world, dev, emit=None) -> dict:
    """Every rank's share of the readings: the calls of each round of
    ``world.size`` seeds, then this rank's judgements, then rank 0 emits
    the round's readings."""
    import torch

    from gpubench import harness, ranks

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mod = cell.entry
    world.join(JUDGE_TIMEOUT_S)
    call = harness.entry_call(cell, bt, dev)
    sound, control, planted = {}, {}, {}

    def fold(table, key, values, pick):
        for k, v in values.items():
            table.setdefault(key, {})
            table[key][k] = v if k not in table[key] else pick(table[key][k], v)

    def read(sides, inputs):
        each = getattr(mod, "output_readings", None)
        if each is not None:            # one reference for every side of the seed
            return each(cell, sides, inputs)
        return {side: mod.judge(cell, {side: out}, inputs)[1] for side, out in sides.items()}

    for r0 in range(0, len(seeds), world.size):
        mine = []
        for i in range(r0, min(r0 + world.size, len(seeds))):
            inputs = mod.make_inputs(cell, seeds[i], dev)
            if world.size > 1:
                world.same_inputs(ranks.checksum(inputs))
            t = time.perf_counter()
            out = mod.output(call(inputs))
            call_s = time.perf_counter() - t
            faulted = {}
            if i < n_faults:
                for name in mod.FAULTS:
                    with mod.planted(name):
                        faulted[name] = mod.output(call(inputs))
            sync()
            if i % world.size == world.rank:
                mine.append((i, inputs, out, call_s, faulted))
            del inputs, out, faulted
        rows = []
        for i, inputs, out, call_s, faulted in mine:
            head = {"workload": cell.name, "seed": seeds[i]}
            sides = {"program": out}
            if i < n_control:
                t = time.perf_counter()
                sides["control"] = mod.control(cell, inputs)
                head["control_s"] = time.perf_counter() - t
            sides.update((f"fault:{name}", fout) for name, fout in faulted.items())
            t = time.perf_counter()
            values = read(sides, inputs)
            head["reference_s"] = time.perf_counter() - t
            rows.append((i, 0, {**head, "side": "program", "call_s": call_s,
                                "readings": values["program"]}))
            for j, side in enumerate(list(sides)[1:]):
                rows.append((i, 1 + j, {**head, "side": side, "readings": values[side]}))
        del mine
        if on_card:
            torch.cuda.empty_cache()
        every = [row for part in world.gather(rows) for row in part]
        if world.rank:
            continue
        for _, _, row in sorted(every, key=lambda r: r[:2]):
            emit(row)
            side = row["side"]
            if side == "program":
                fold(sound, "program", row["readings"], max)
            elif side == "control":
                fold(control, "control", row["readings"], min)
            else:
                fold(planted, side[len("fault:"):], row["readings"], min)
    return {"program_max": sound.get("program", {}), "control_min": control.get("control", {}),
            "faults_min": planted}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--out", default=None)
    from gpubench import ranks

    ranks.add_worker_args(ap)       # a worker of a cell on several cards, started by rank 0
    args = ap.parse_args(argv)

    if args.rank:
        ranks.die_with_parent(args.parent)
    # one thread a process, as run.py's: ranks share the host's cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    import batchelor_torch as bt
    from gpubench import harness

    seeds = [int(s) for s in args.seeds.split(",")]
    if args.rank:
        cell = harness.load_cell(args.workload, Path(args.root))
        world = ranks.World.of_worker(args)
        read_rounds(cell, bt, seeds, args.control, args.faults, world, world.dev)
        world.close()
        return 0

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"readings: {args.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    mod = cell.entry
    for flag, needs in ((args.control, "control"), (args.faults, "planted")):
        if flag and not hasattr(mod, needs):
            print(f"readings: the entry module {mod.__file__} has no {needs}", file=sys.stderr)
            return 2
    sink = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    try:
        summary = read_cell(cell, bt, seeds, args.control, args.faults, "cuda", emit)
        emit({"workload": cell.name, "summary": summary, "limits": cell.limits,
              "card": torch.cuda.get_device_name(0)})
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that a cell's limits are set from, on the card, for many
seeds in one process (set-up is long): the program's (the lower reading),
the control's and the faults' (the upper reading).

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...] [--control-seeds <n> ...] [--out FILE]

For every seed of ``--seeds`` the program is set up as a run sets it up
(its first steps or its first pass) and judged against the reference as a
run judges it, with no measured window: training's readings need none,
and a pseudo-label pass's labels are the same in every call.  For every
seed of ``--control-seeds`` the cell's ``kinds/<kind>.py`` reads its
``control``: the reference put in the program's place and computed one
precision below the configuration's (float8 e4m3 products for bf16), and
the faults its kind can have (training: half of each batch left out of the
loss, the mean taken over the rest; labelling: one word of each row's
label altered where it is produced), each judged against the reference.

Each reading is a line of JSON on standard output, and appended to
``--out`` where one is given.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(prog="benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="a file to append the readings to, as well")
    args = ap.parse_args()

    import torch

    from benchmark import harness as H

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        H.log("benchmark.control: needs a CUDA device")
        return 2
    cell = H.load_cell(args.workload)
    sink = open(args.out, "a", encoding="utf-8") if args.out else None

    def emit(**row):
        line = json.dumps(row, default=float)
        print(line, flush=True)
        if sink is not None:
            sink.write(line + "\n")
            sink.flush()

    for seed in args.seeds:
        t0 = time.perf_counter()
        run = H.Run(cell, seed, device)
        run.setup()
        run.free_program()
        emit(cell=args.workload, seed=seed, side="program", readings=run.judge(), seconds=time.perf_counter() - t0)
        del run
        torch.cuda.empty_cache()

    kind = H.load_module("kinds", cell["traffic"]["kind"])
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        for side, readings in kind.control(cell, seed, device):
            emit(cell=args.workload, seed=seed, side=side, readings=readings, seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    if sink is not None:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that a cell's correctness limits are set from, seed by seed
in one process: the program's numbers (the lower reading) and the
control's (the upper one: the reference in the program's place, one
precision step below the configuration's, at the same states).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

For each seed: the cell's weights from the seed, one image of the cell's
traffic (the window's first request) through the program, built as a run
builds it (``program.build_pipe``: the configuration's runtime), then the
reference and the control at the checked steps (step 0 and the later step
that the image's seed draws, as a run's check draws it) and the decode.
One JSON line a seed. Not run by the benchmark's own runs.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device: str = "cuda") -> dict:
    import torch

    from portbench import check, program
    from portbench import traffic as traffic_mod
    from portbench import weights as wts

    cfg, trf, steps = cell.config, cell.traffic, cell.steps
    pipe = program.build_pipe(cfg, wts.make_weights(cfg, seed, device), device)
    req = next(traffic_mod.requests(trf, seed))
    cond = traffic_mod.condition_image(trf, req["seed"], device)
    record = {**req, **program.generate(pipe, trf, steps, req, None, cond)}
    del pipe
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    weights = wts.make_weights(cfg, seed, device)
    out = lambda mode, decode=True: check.reference_outputs(
        cfg, trf, steps, weights, record, device, mode=mode, decode=decode)
    ref, unit, ctl = out("fp32"), out("unit", False), out("control")
    return {"seed": seed, "steps": check.checked_steps(steps, record["seed"]),
            "program": check.program_readings(record, ref, unit),
            "control": check.control_readings(ctl, ref, unit)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.cells import load_cell
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": cell.name, **readings(cell, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Tabulate dry-run cells (``python -m repro_torch.launch.dryrun``).

    python experiments/dryrun_table.py GRID [--before OLD_GRID]

GRID holds the cell files the dry run writes (``<arch>_<shape>_1pod.json``).
One line a cell: compute / memory / collective ms, the bound (C, M, X),
the useful-FLOPs ratio and the peak GiB a device.  With ``--before``,
each cell also gets its FLOPs and collective bytes a device over those
of the same cell in OLD_GRID (an earlier run), so a change's effect on
each count reads as a factor.  Skipped cells print as skipped.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

BOUND = {"compute": "C", "memory": "M", "collective": "X"}


def _cells(grid: Path) -> dict:
    return {p.stem: json.loads(p.read_text())
            for p in sorted(grid.glob("*.json"))}


def line(cell: dict, before: dict = None) -> str:
    if cell.get("status") != "ok":
        return cell.get("status", "missing")
    out = (f"{cell['compute_s'] * 1e3:.2f} / {cell['memory_s'] * 1e3:.2f} / "
           f"{cell['collective_s'] * 1e3:.2f}, {BOUND[cell['bound']]}, "
           f"{cell['useful_flops_ratio']:.2f}, "
           f"{cell['peak_bytes_per_device'] / 2**30:.2f} GiB")
    if before is not None and before.get("status") == "ok":
        flops = cell["flops_per_device"] / before["flops_per_device"]
        coll = (cell["collective_bytes_per_device"]
                / max(before["collective_bytes_per_device"], 1.0))
        out += f"; FLOPs x{flops:.4f}, collective bytes x{coll:.4f}"
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("grid")
    ap.add_argument("--before", default=None)
    args = ap.parse_args(argv)
    cells = _cells(Path(args.grid))
    old = _cells(Path(args.before)) if args.before else {}
    for tag, cell in cells.items():
        print(f"{tag}: {line(cell, old.get(tag) if args.before else None)}")


if __name__ == "__main__":
    main()

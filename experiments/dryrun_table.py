"""Tabulate dry-run cells (``python -m repro_torch.launch.dryrun``).

    python experiments/dryrun_table.py GRID [--before OLD_GRID] \
        [--reference REF_GRID]

GRID holds the cell files the dry run writes (``<arch>_<shape>_1pod.json``).
One line a cell: compute / memory / collective ms, the bound (C, M, X),
the useful-FLOPs ratio and the peak GiB a device.  With ``--before``,
each cell also gets its FLOPs, collective bytes and peak bytes a device
over those of the same cell in OLD_GRID (an earlier run), so a change's
effect on each count reads as a factor.  With ``--reference``, over
those of the reference's cell of the same name in REF_GRID (``python -m
repro.launch.dryrun --arch ARCH --shape SHAPE --out REF_GRID`` on a CPU
host, one cell a run), its peak over the reference's (XLA's
``memory_analysis``: temp + arguments + outputs - aliases).  Skipped cells print as skipped.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

BOUND = {"compute": "C", "memory": "M", "collective": "X"}


def _cells(grid: Path) -> dict:
    return {p.stem: json.loads(p.read_text())
            for p in sorted(grid.glob("*.json"))}


def _over(cell: dict, other: dict) -> tuple:
    """(FLOPs, collective bytes, peak bytes) a device of ``cell`` over
    ``other``'s (the peak None where ``other`` has none)."""
    peak = other.get("peak_bytes_per_device")
    return (cell["flops_per_device"] / other["flops_per_device"],
            cell["collective_bytes_per_device"]
            / max(other["collective_bytes_per_device"], 1.0),
            cell["peak_bytes_per_device"] / peak if peak else None)


def line(cell: dict, before: dict = None, reference: dict = None) -> str:
    if cell.get("status") != "ok":
        return cell.get("status", "missing")
    out = (f"{cell['compute_s'] * 1e3:.2f} / {cell['memory_s'] * 1e3:.2f} / "
           f"{cell['collective_s'] * 1e3:.2f}, {BOUND[cell['bound']]}, "
           f"{cell['useful_flops_ratio']:.2f}, "
           f"{cell['peak_bytes_per_device'] / 2**30:.2f} GiB")
    if before is not None and before.get("status") == "ok":
        flops, coll, peak = _over(cell, before)
        out += f"; FLOPs x{flops:.4f}, collective bytes x{coll:.4f}, " \
               f"peak x{peak:.4f}"
    if reference is not None and reference.get("status") == "ok":
        flops, coll, peak = _over(cell, reference)
        out += f"; {flops:.3g}x, {coll:.3g}x the reference's"
        if peak is not None:
            out += f", peak {peak:.3g}x"
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("grid")
    ap.add_argument("--before", default=None)
    ap.add_argument("--reference", default=None)
    args = ap.parse_args(argv)
    cells = _cells(Path(args.grid))
    old = _cells(Path(args.before)) if args.before else {}
    ref = _cells(Path(args.reference)) if args.reference else {}
    for tag, cell in cells.items():
        print(f"{tag}: {line(cell, old.get(tag), ref.get(tag))}")


if __name__ == "__main__":
    main()

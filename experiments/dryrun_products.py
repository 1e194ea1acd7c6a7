"""The products of one dry-run cell, largest first.

    PYTHONPATH=src python experiments/dryrun_products.py ARCH SHAPE \\
        [--device cuda] [--multi-pod] [--top 15] [--out GRID]

Traces the cell as ``python -m repro_torch.launch.dryrun`` does (a fake
process group of 256 or 512 ranks, rank 0's step recorded) and prints
the FLOPs a device of its products (the ops ``flop_registry`` counts,
and the kernel ops as ``core.costmodel`` counts them), grouped by op and
operand shapes, largest first, beside the cell's totals; then its
collectives' output bytes a device, grouped by op and output shape; then
the storage live at the rank's peak (``hlo_analysis.live_at_peak``),
grouped by the op that made it and its shape, largest first (the step's
state reads as ``placeholder``), with the output's own bytes beside the
storage's where the output is a view of a larger storage (a collective's
is charged at its own bytes, an ordinary op's view at its storage's).  With ``--out`` it also writes the cell
file into GRID as the dry run does.  Use it to find the products that
read above the reference's dots in a cell, and what holds its peak.
"""

from __future__ import annotations

import argparse
import collections
import json
from pathlib import Path

from repro_torch.launch import dryrun, hlo_analysis


def products(graphs) -> dict:
    """(op, operand shapes) -> [calls, FLOPs] over the graph's products."""
    out: dict = collections.defaultdict(lambda: [0, 0.0])
    for g in hlo_analysis._graphs(graphs):
        for node in g.nodes:
            if node.op != "call_function" or \
                    hlo_analysis._is_free(node.target) or \
                    hlo_analysis.collective_class(node.target):
                continue
            args = hlo_analysis._vals(node.args)
            flops, reg = hlo_analysis.node_flops(
                node.target, args, hlo_analysis._vals(node.kwargs),
                node.meta.get("val"))
            kernel = getattr(node.target, "namespace", "") == "repro_torch"
            if not (reg or kernel) or not flops:
                continue
            shapes = tuple(tuple(a.shape) for a in args
                           if hasattr(a, "shape"))
            row = out[(str(node.target), shapes)]
            row[0] += 1
            row[1] += flops
    return out


def collectives(graphs) -> dict:
    """(collective, output shape) -> [calls, bytes] over the graph."""
    out: dict = collections.defaultdict(lambda: [0, 0.0])
    for g in hlo_analysis._graphs(graphs):
        for node in g.nodes:
            if node.op == "call_function" and \
                    hlo_analysis.collective_class(node.target):
                val = node.meta.get("val")
                row = out[(str(node.target),
                           tuple(getattr(val, "shape", ())))]
                row[0] += 1
                row[1] += hlo_analysis._nbytes(val)
    return out


def peak(graphs) -> tuple:
    """(the peak bytes, {(op, shape): [storages, bytes charged, the
    outputs' own bytes, the storages' bytes]} live at it)."""
    top, live = hlo_analysis.live_at_peak(graphs)
    out: dict = collections.defaultdict(lambda: [0, 0.0, 0.0, 0.0])
    for nbytes, op, shape, own, storage in live:
        row = out[(op, shape)]
        row[0] += 1
        row[1] += nbytes
        row[2] += own
        row[3] += storage
    return top, out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    graphs = []
    analyze = hlo_analysis.analyze

    def keep(g, chips):
        graphs.append(g)
        return analyze(g, chips)
    hlo_analysis.analyze = keep
    dryrun.fake_group(512 if args.multi_pod else 256)
    cell = dryrun.run_cell(args.arch, args.shape, args.multi_pod,
                           verbose=True, device=args.device)
    rows = sorted(products(graphs[0]).items(), key=lambda kv: -kv[1][1])
    total = sum(f for _, (_, f) in rows)
    print(f"{args.arch} {args.shape}: {cell['flops_per_device']:.4e} FLOPs "
          f"a device, {total:.4e} of them in products")
    for (op, shapes), (calls, flops) in rows[:args.top]:
        print(f"  {flops:.4e} ({flops / total:.1%}) {calls} x {op} "
              f"{' x '.join(str(s) for s in shapes)}")
    rows = sorted(collectives(graphs[0]).items(), key=lambda kv: -kv[1][1])
    total = sum(b for _, (_, b) in rows)
    print(f"  collectives: {total:.4e} bytes a device")
    for (op, shape), (calls, nbytes) in rows[:args.top]:
        print(f"  {nbytes:.4e} ({nbytes / max(total, 1.0):.1%}) {calls} x "
              f"{op} -> {shape}")
    top, live = peak(graphs[0])
    rows = sorted(live.items(), key=lambda kv: -kv[1][1])
    print(f"  peak: {top / 2**30:.2f} GiB a device live at once")
    for (op, shape), (count, nbytes, own, storage) in rows[:args.top]:
        view = "" if own >= storage else \
            f" [a view: its own {own / 2**30:.3f} GiB of a " \
            f"{storage / 2**30:.3f} GiB storage]"
        print(f"  {nbytes / 2**30:.3f} GiB ({nbytes / max(top, 1.0):.1%}) "
              f"{count} x {op} -> {shape}{view}")
    if args.out:
        tag = f"{args.arch}_{args.shape}_{'2pod' if args.multi_pod else '1pod'}"
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / f"{tag}.json").write_text(json.dumps(cell,
                                                               indent=1))


if __name__ == "__main__":
    main()

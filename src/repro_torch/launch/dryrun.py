"""Multi-pod dry run: trace every (architecture x input shape) cell on the
production meshes, read its roofline terms and peak memory from the
traced per-rank graph (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell with ``jax.jit`` on 256 or
512 placeholder host devices and walks the per-device HLO.  Here a
*fake* process group (``torch.distributed``'s ``"fake"`` backend: no
communication) of 256 or 512 ranks in one process stands in for the
devices; ``launch.mesh.make_production_mesh`` builds the (16, 16) or (2,
16, 16) mesh over it; the cell's state is made of DTensors placed by
``parallel.sharding``'s rules whose local tensors (rank 0's shards) live
on the ``meta`` device, so no memory is allocated and no kernel
launches; and ``hlo_analysis.trace`` records rank 0's step as an FX
graph (the forward, autograd's backward, the optimizer and DTensor's
collectives), which ``hlo_analysis.analyze`` reads.  The graph is read,
not run: nothing is compiled.

One default process group exists per process, so a cell refuses to run
inside a real one (``chip_smoke.py`` runs the dry run as a subprocess).
``--device`` is the fake mesh's device type (default ``cuda``; ``cpu``
where there is no GPU); the cell's numbers do not depend on it, but the
collectives DTensor picks do: a CPU group has no all-to-all, so MoE's
exchange reads as an all-gather there.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--both]
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import hlo_analysis, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES
from repro_torch.parallel import ctx, sharding
from repro_torch.parallel.ctx import mesh_shape
from repro_torch.train.optim import adamw

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

def model_flops(cfg, shape) -> float:
    """6·N_active·D for training; 2·N_active per generated token for decode."""
    n_active = cfg.n_active_params()
    if shape.mode == "train":
        return 6.0 * n_active * shape.tokens
    if shape.mode == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch  # one token per sequence


def fake_group(world: int, replace: bool = False) -> None:
    """Make sure a fake process group runs: start one of ``world`` ranks
    (this process is rank 0) when none does, keep a fake one already
    running (its size then sets the mesh; ``replace`` starts one of
    ``world`` ranks in its place), and refuse a real one."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry run needs a fake process group, and a "
                f"{dist.get_backend()!r} group is running in this process: "
                "run it in a process of its own")
        if not replace or dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _abstract_leaf(leaf, sh: sharding.Sharding):
    """A DTensor of ``leaf``'s global shape and dtype placed as ``sh``
    says, whose local tensor (this rank's shard) is on ``meta``."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    out = sharding.shard_of(leaf, sh, "meta")
    return out.requires_grad_(leaf.requires_grad)


def _placed(tree, spec_tree, mesh):
    return sharding.distribute(tree, sharding.tree_shardings(spec_tree, mesh),
                               put=_abstract_leaf)


def _profile(cfg, shape, chips: int) -> str:
    profile = getattr(cfg, "sharding_profile", "2d")
    if shape.mode != "train" and getattr(cfg, "sharding_profile_serve", ""):
        profile = cfg.sharding_profile_serve
    if profile == "dp" and shape.global_batch % chips != 0:
        # pure DP requires global_batch >= devices (e.g. batch 256 on the
        # 512-chip 2-pod mesh): fall back to 2D FSDPxTP
        profile = "2d"
    return profile


def _set_axes(profile: str) -> None:
    if profile == "dp":
        ctx.set_batch_axes(("pod", "data", "model"))
        ctx.set_seq_axes(())
    elif profile == "sp":
        ctx.set_batch_axes(("pod", "data"))
        ctx.set_seq_axes(("model",))
    else:
        ctx.set_batch_axes(("pod", "data"))
        ctx.set_seq_axes(())


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             verbose: bool = True, device: str = "cuda"):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return {"arch": arch, "shape": shape_name,
                "multi_pod": multi_pod, "status": "skipped",
                "reason": "pure full-attention arch; long_500k requires "
                          "sub-quadratic attention (DESIGN.md §4)"}

    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    shape_of = mesh_shape(mesh)
    chips = 1
    for n in shape_of.values():
        chips *= n
    optimizer = adamw()
    t0 = time.time()

    profile = _profile(cfg, shape, chips)
    try:
        with ctx.use_mesh(mesh):
            _set_axes(profile)
            step_fn = specs.step_fn_for(cfg, shape, optimizer, profile)
            batch_abs = specs.input_specs(cfg, shape)
            batch = _placed(batch_abs, sharding.batch_specs(
                batch_abs, mesh, profile=profile), mesh)
            if shape.mode == "train":
                state_abs = specs.abstract_train_state(cfg, optimizer)
                args = (_placed(state_abs, sharding.param_specs(
                    state_abs, mesh, profile, cfg=cfg), mesh), batch)
            else:
                params_abs = specs.abstract_params(cfg)
                params = _placed(params_abs, sharding.param_specs(
                    params_abs, mesh, profile, cfg=cfg), mesh)
                args = (params, batch)
                if shape.mode == "decode":
                    dstate_abs = specs.abstract_decode_state(
                        cfg, shape.global_batch, shape.seq_len)
                    args += (_placed(dstate_abs, sharding.cache_specs(
                        dstate_abs, mesh, shape.global_batch, cfg), mesh),)
            t_lower = time.time() - t0
            state_bytes = sum(t.numel() * t.element_size()
                              for t in hlo_analysis.leaves(args))
            graph, _ = hlo_analysis.trace(step_fn, *args)
            t_trace = time.time() - t0 - t_lower
    finally:
        _set_axes("2d")

    roof = hlo_analysis.analyze(graph, chips)
    mf = model_flops(cfg, shape)
    total_flops = roof.flops_per_device * chips
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "chips": chips,
        "mesh": dict(shape_of),
        "lower_s": round(t_lower, 1), "compile_s": round(t_trace, 1),
        "model_flops": mf,
        "useful_flops_ratio": mf / max(total_flops, 1.0),
        "device": mesh.device_type, "profile": profile,
        "graph_nodes": len(graph.graph.nodes),
        "state_bytes_per_device": float(state_bytes),
        **roof.as_dict(),
    }
    if verbose:
        print(f"[{arch} x {shape_name} x "
              f"{'2pod' if multi_pod else '1pod'}] "
              f"compute {roof.compute_s * 1e3:.2f}ms "
              f"memory {roof.memory_s * 1e3:.2f}ms "
              f"collective {roof.collective_s * 1e3:.2f}ms "
              f"-> {roof.bound}-bound "
              f"(useful flops {result['useful_flops_ratio']:.2f}, "
              f"peak {roof.peak_bytes_per_device / 2**30:.2f} GiB, "
              f"trace {t_trace:.0f}s)", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod AND multi-pod meshes")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--device", default="cuda",
                    help="the fake mesh's device type (cuda or cpu)")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = [False, True] if args.both else [args.multi_pod]

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in pods:
                tag = f"{arch}_{shape_name}_{'2pod' if mp else '1pod'}"
                path = out_dir / f"{tag}.json"
                if path.exists():
                    print(f"[skip existing] {tag}")
                    continue
                try:
                    fake_group(512 if mp else 256, replace=True)
                    result = run_cell(arch, shape_name, mp,
                                      device=args.device)
                except Exception as e:
                    failures += 1
                    result = {"arch": arch, "shape": shape_name,
                              "multi_pod": mp, "status": "error",
                              "error": f"{type(e).__name__}: {e}",
                              "traceback": traceback.format_exc()[-2000:]}
                    print(f"[FAIL] {tag}: {result['error']}")
                path.write_text(json.dumps(result, indent=1))
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()

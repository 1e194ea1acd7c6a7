"""Where the training gates of ``chip_smoke.py`` phase 18 (a) come from.

Runs phase 18 (a) on one H100 (the gradient gate and the op gate of
Qwen3-0.6B and Mamba2-130M at their published configs) for each seed
given, printing every gate's figures and, where a gate fails, what it
would fail on instead of stopping; then holds the kernel's y and
``ssd_chunked``'s (at the reference's chunk of 256 and at 64) against the
sequential fp32 oracle ``ssd_plain`` on the inputs the bf16 training
step gives the scan in three of Mamba2's layers:

  python experiments/gradient_floors.py [--seeds 0,1]

Needs a CUDA GPU; builds the kernels first.  The limits that
``chip_smoke.py`` sets from these figures are ``GRAD_REL``,
``BF16_LOSS_REL`` and ``OP_SSD_ROW_REL``.
"""

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd as sk  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402


def scan_against_sequential(device, layers=(0, 11, 23)) -> None:
    cfg = get_config("mamba2-130m")
    calls = cs.op_inputs(torch, cfg, device, "ssd")
    for layer in layers:
        args, kwargs = calls[layer]
        x, dt, a, bm, cm = args[:5]
        with torch.no_grad():
            seq, _ = sk.ssd_plain(x, dt, a, bm, cm)
            floor = cs.OP_ROW_FLOOR * float(seq.abs().max())
            ys = {"kernel": sk.ssd(*args[:5], **kwargs)[0]}
            for chunk in (cfg.ssm_chunk, 64):
                ys[f"ssd_chunked {chunk}"] = ssm_mod.ssd_chunked(
                    x.transpose(1, 2), dt.transpose(1, 2), a,
                    bm.transpose(1, 2), cm.transpose(1, 2),
                    chunk=chunk).transpose(1, 2)
            for name, y in ys.items():
                err, tol, top = cs._row_err(torch, y, seq, 1.0, floor)
                print(f"  layer {layer} {name} against the sequential "
                      f"oracle: worst row {err / tol:.3e} of its largest "
                      f"|y|, max |err| {top:.3e} (max |y| "
                      f"{float(seq.abs().max()):.3e}; dt "
                      f"{float(dt.min()):.3e}..{float(dt.max()):.3e}, a "
                      f"{float(a.min()):.3f}..{float(a.max()):.3f})",
                      flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    cs.fail = lambda msg: print(f"  a gate would fail: {msg}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build_all()
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        cs.SEED = seed
        print(f"seed {seed}", flush=True)
        for arch, kname in cs.TRAIN_ARCHS.items():
            cfg = get_config(arch)
            cs.gradient_gate(torch, cfg, device, kname)
            cs.op_gate(torch, cfg, device, kname)
    cs.SEED = 0
    print("the scan against its sequential oracle, seed 0", flush=True)
    scan_against_sequential(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Content-addressed store for trained-MLP artifacts.

A copy of ``repro.core.artifacts``.  An artifact is keyed on a hash of
**what determines the trained weights**:

* :data:`TRAINING_SEMANTICS_VERSION` — bumped by hand when the dataset
  sampling, the simulator's timing model, or the MLP training loop
  changes *behavior* (a code move/rename does not);
* the op kind, the full ``MLPConfig`` (depth/width/epochs/lr/seed), the
  dataset size and seed;
* the resolved specs of every device the dataset is measured on.

The port's registry and ``MLPConfig`` match the reference's field for
field, so the keys come out equal and both packages share one
``artifacts/mlps/`` directory: each loads the other's sealed artifacts::

    artifacts/mlps/linear_h3x256_e30_n2000_c0ffee123456.pkl

``python -m repro_torch.core.artifacts --ci-key`` prints one combined key
over the artifact sets CI trains (the default predictor's and the
paper-parity set's), equal to the reference's ``--ci-key``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Optional, Sequence, Union

from repro_torch.core import devices, mlp

__all__ = ["TRAINING_SEMANTICS_VERSION", "mlp_content_key",
           "artifact_path", "ci_cache_key"]

#: Bump when artifact-producing *behavior* changes: dataset sampling
#: (``dataset.sample_ops`` / ``build_dataset`` / ``transform_features``),
#: simulator timing (``simulator.op_time_ms``), or the MLP training loop
#: (``mlp.train`` / losses / init).  Pure refactors must NOT bump it.
TRAINING_SEMANTICS_VERSION = 1

#: ``build_dataset``'s default sampling seed (part of the content).
DATASET_SEED = 0

#: The paper-parity MLP set (6 x 512, 15 epochs, 2,500 configurations).
#: The reference keeps these in ``benchmarks/common.py``, which imports
#: JAX, so the port holds its own copy; ``ci_cache_key`` must match the
#: reference's string, which a parity test checks.
PAPER_MLP_CFG = mlp.MLPConfig(hidden_layers=6, hidden_size=512, epochs=15)
PAPER_MLP_CONFIGS = 2500


def _resolve_devices(device_names: Optional[Sequence[str]]) -> list:
    if device_names is None:
        device_names = sorted(devices.all_devices())
    return [list(dataclasses.astuple(devices.get(n)))
            for n in device_names]


def mlp_content_key(kind: str, cfg, n_configs: int,
                    device_names: Optional[Sequence[str]] = None,
                    dataset_seed: int = DATASET_SEED) -> str:
    """Hex digest of everything that determines one trained artifact."""
    spec = {
        "v": TRAINING_SEMANTICS_VERSION,
        "kind": kind,
        "cfg": dataclasses.asdict(cfg),
        "n_configs": int(n_configs),
        "dataset_seed": int(dataset_seed),
        "devices": _resolve_devices(device_names),
    }
    blob = json.dumps(spec, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def artifact_path(cache_dir: Union[str, Path], kind: str, cfg,
                  n_configs: int,
                  device_names: Optional[Sequence[str]] = None) -> Path:
    """Content-addressed path for one (kind, config, dataset) artifact."""
    tag = (f"h{cfg.hidden_layers}x{cfg.hidden_size}"
           f"_e{cfg.epochs}_n{n_configs}")
    key = mlp_content_key(kind, cfg, n_configs, device_names)[:12]
    return Path(cache_dir) / f"{kind}_{tag}_{key}.pkl"


def ci_cache_key() -> str:
    """One combined key over every artifact set CI trains.

    Covers all four op kinds for (a) the default predictor's config and
    (b) the paper-parity config, both against the full device registry
    (their ``device_names=None`` default)."""
    from repro_torch.core import predictor as predictor_mod

    sets = [(predictor_mod.DEFAULT_MLP_CFG, predictor_mod.DEFAULT_N_CONFIGS),
            (PAPER_MLP_CFG, PAPER_MLP_CONFIGS)]
    h = hashlib.sha256()
    for cfg, n_configs in sets:
        for kind in ("conv2d", "linear", "bmm", "recurrent"):
            h.update(mlp_content_key(kind, cfg, n_configs).encode())
    return f"mlps-v{TRAINING_SEMANTICS_VERSION}-{h.hexdigest()[:16]}"


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="content-addressed MLP artifact keys")
    ap.add_argument("--ci-key", action="store_true",
                    help="print the combined actions/cache key")
    args = ap.parse_args(argv)
    if args.ci_key:
        print(ci_cache_key())
    else:
        from repro_torch.core import predictor as predictor_mod
        cfg = predictor_mod.DEFAULT_MLP_CFG
        n = predictor_mod.DEFAULT_N_CONFIGS
        for kind in ("conv2d", "linear", "bmm", "recurrent"):
            print(artifact_path(predictor_mod.ARTIFACT_DIR, kind, cfg, n))


if __name__ == "__main__":
    main()

"""The port's sharded training on 8 gloo CPU ranks (the reference's
``tests/test_sharding.py``, which runs on 8 placeholder devices).

One spawn of 8 ranks (``tests/sharding_ranks.py``, a ``FileStore`` in a
temporary directory for the rendezvous, one intra-op thread a rank) runs
every 8-rank case once for the module, and a spawn of 4 ranks restores
the checkpoint it saved; each test reads its own case's result.  Each
case holds the mesh's result against the same computation on plain
tensors, one AdamW step (lr 1e-3, clip 1.0) of a smoke config on 8 x 16
seeded tokens, at the reference's tolerances (``tests/test_sharding.py:
63-69``): loss within 1e-4, every parameter within 2e-4.  The plain
single-device step is itself held against the reference's by
``tests/test_torch_train_step.py::test_adamw_step_matches_reference``.
The attention cases hold the model's per-shard paths on the 2x4 and 4x2
meshes: prefill logits and the loss's ``wq``/``wk``/``wv`` gradients
with the query heads split over ``model`` (a KV head's gradient summed
over the ranks that read it), and decode from per-shard softmax partials
where the cache's sequence is split, at the same tolerances (and with
every product planned per shard, smoke Mamba2 and internvl2 at widths
that do not divide ``model``, none repeated on a mesh dim's ranks);
prefill and training with the query sequence split over ``model`` where the
heads cannot be (6 heads on ``model=4``), the per-shard embedding lookup
under ``2d``, ``dp`` and ``sp``, and the per-shard SwiGLU.  Under ``dp``
with the batch over the whole mesh, as the dry run places it: the MoE
router's gradient (its dispatch groups over both mesh dims), the output
projection tied to the embedding table, and zamba2's Mamba2 layers run
per shard, with the collectives the ranks issue read from a dispatch
mode.  Under ``2d`` the Mamba2 block runs on each ``model`` rank's range
of the heads (smoke Mamba2 with heads that do not divide ``model=4``,
and zamba2 with ``in_proj`` split over it): prefill, decode and the
loss's gradients.  ``chip_smoke.py`` runs the ``guard`` set of these
cases on the card's torch release and holds it to
:func:`sharding_ranks.failures`.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

import sharding_ranks
from sharding_ranks import LOSS_TOL, PARAM_TOL

HERE = Path(__file__).resolve().parent
#: a spawn's own limit: the 8-rank cases take about a minute here
SPAWN_TIMEOUT_S = 600


def _spawn(cases: str, world: int, out_dir: Path) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "sharding_ranks.py"), cases, str(rank),
         str(world), str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for rank in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    result = out_dir / f"{cases}.json"
    assert result.exists(), "\n".join(log[-3000:] for log in logs)
    return json.loads(result.read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("sharding")
    results = _spawn("mesh8", 8, out_dir)
    if "error" not in results.get("save", {"error": "not run"}):
        results.update(_spawn("mesh4", 4, out_dir))
    return results


def _case(runs, name):
    got = runs.get(name)
    assert got is not None, f"case {name} did not run"
    assert "error" not in got, got.get("error")
    return got


@pytest.mark.parametrize("name", ["2d", "dp", "sp", "accum"])
def test_sharded_train_step_matches_single_device(runs, name):
    """qwen3-0.6b smoke on a 4x2 mesh under ``2d`` (with and without 2
    accumulation microbatches) and ``dp``; mamba2-130m smoke under ``sp``
    (the sequence over 'model': the SSD rule gathers it)."""
    got = _case(runs, name)
    assert got["loss_gap"] < LOSS_TOL, got
    assert got["param_gap"] < PARAM_TOL, got
    assert got["split_leaves"] > 0, got


def test_gqa_heads_over_a_wider_model_axis(runs):
    """4 query heads and 2 KV heads on a 2x4 mesh: q's heads split over
    ``model=4`` beside k and v that cannot be, so each rank reads a slice
    of the gathered KV heads (a shard reading its own KV heads would read
    the wrong ones)."""
    got = _case(runs, "gqa")
    assert (got["heads"], got["kv_heads"]) == (4, 2)
    assert got["loss_gap"] < LOSS_TOL, got
    assert got["param_gap"] < PARAM_TOL, got


def test_moe_expert_parallel_matches(runs):
    """granite-moe smoke, 4 experts over ``model=4`` (EP), top-2 at
    lossless capacity 4.0, on a 2x4 mesh: two dispatch groups, one a
    batch shard, against one group on a single device."""
    got = _case(runs, "ep")
    assert got["expert_split"][1] == "Shard(0)", got
    assert got["loss_gap"] < LOSS_TOL, got


@pytest.mark.parametrize("profile, groups", [("2d", 2), ("dp", 8)])
def test_moe_router_gradient_matches(runs, profile, groups):
    """The same granite on the 2x4 mesh: every parameter's gradient, the
    router's among them, at the parameter tolerance.  Each rank routes
    its own dispatch groups (2 under ``2d``, one a ``data`` rank; 8
    under ``dp``, one a rank of both mesh dims), so the router's
    gradient is a sum over the ranks that split the groups."""
    got = (_case(runs, "ep")["grads"] if profile == "2d"
           else _case(runs, "ep_dp"))
    assert got["groups"] and set(got["groups"]) == {groups}, got["groups"]
    routers = [n for n in got["grad_gap"] if n.endswith(".router")]
    assert len(routers) == 2, got["grad_gap"]
    assert got["grad_scale"] > 0
    for name, gap in got["grad_gap"].items():
        assert gap < PARAM_TOL, (name, got)
    assert got["logit_gap"] < LOSS_TOL, got


def test_tied_head_under_dp_matches_single_device(runs):
    """Smoke gemma3, whose output projection is the embedding table's
    transpose, under ``dp`` on the 4x2 mesh (the batch, 8 sequences, and
    the table's vocab both split over the whole mesh): the logits and
    every gradient, the table's among them, against plain tensors; and
    no collective gives a rank a logits block of more sequences than its
    own one, or the global batch's activations (the head is gathered as
    FSDP gathers a weight, its gradient reduce-scattered back)."""
    got = _case(runs, "tied_dp")
    assert got["tied"] and got["collectives"] > 0, got
    assert got["crossing"] == [], got["crossing"]
    assert got["logit_gap"] < LOSS_TOL, got
    assert "embed" in got["grad_gap"] and got["grad_scale"] > 0
    for name, gap in got["grad_gap"].items():
        assert gap < PARAM_TOL, (name, got)


def test_zamba2_dp_train_step_matches_single_device(runs):
    """A training step of smoke zamba2 under ``dp`` on the 4x2 mesh, one
    sequence a rank: the loss and every updated parameter against plain
    tensors; each Mamba2 layer's scan ran on the rank's plain sequence
    (``ssm.mamba_block`` per shard), no projection's gradient was
    all-reduced whole (each is reduce-scattered back to its split), and
    no collective gave a rank other ranks' sequences."""
    got = _case(runs, "zamba2_dp")
    assert got["ssd_calls"], got
    assert all(c == [False, 1] for c in got["ssd_calls"]), got["ssd_calls"]
    assert got["whole_reduced"] == [], got["whole_reduced"]
    assert got["crossing"] == [], got["crossing"]
    assert got["loss_gap"] < LOSS_TOL, got
    assert got["param_gap"] < PARAM_TOL, got


def test_the_card_guard_cases_pass_its_gate(runs):
    """The ``guard`` set that ``chip_smoke.py`` runs on the card's torch
    release: every one of its cases ran here, and the card's gate
    (``sharding_ranks.failures``: errors, gaps over the tolerances above,
    collectives that cross ranks' sequences) finds nothing in them."""
    guard = {name: runs.get(name) for name in sharding_ranks.GUARD_CASES}
    assert all(v is not None for v in guard.values()), guard.keys()
    assert sharding_ranks.failures(guard) == []


def test_prefill_and_decode_on_the_mesh(runs):
    """A prefill and 3 decode ticks with the cache placed by
    ``cache_specs``: qwen3 (KV caches) and zamba2 (per-layer Mamba2
    states beside the shared block's caches) on the 4x2 mesh, and smoke
    Mamba2 and internvl2 on the 2x4 mesh with a vocabulary, a Mamba2
    ``in_proj`` and an FFN that do not divide ``model=4``
    (``sharding_ranks.UNEVEN``: their decode products split unevenly),
    fp32, against plain tensors (sums over split dims in another order):
    logits, KV caches and Mamba2 states."""
    got = _case(runs, "decode")
    assert set(got) == {"qwen3-0.6b", "zamba2-2.7b", "mamba2-130m/uneven",
                        "internvl2-2b/uneven"}, sorted(got)
    for arch, r in got.items():
        assert r["logit_gap"] < 1e-4, (arch, r)
        gaps = [k for k in ("k_gap", "v_gap", "state_gap") if k in r]
        assert gaps, (arch, r)
        for k in gaps:
            assert r[k] < 1e-4, (arch, k, r)
        assert r["repeated"] == [], (arch, r)
    # the uneven widths really were cut unevenly: the vocabulary, and
    # Mamba2's in_proj (2 x 96 + 2 x 16 + 6) or internvl2's FFN
    assert got["mamba2-130m/uneven"]["uneven"] == [230, 250], got
    assert 250 in got["internvl2-2b/uneven"]["uneven"], got
    assert 126 in got["internvl2-2b/uneven"]["uneven"], got


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "gemma3-1b"])
def test_one_slot_takes_the_ranks_slice_of_x(runs, arch):
    """One slot on the 4x2 mesh (``long_500k``'s batch): x split over
    ``model`` by the norm's scale reaches the weights whose K splits over
    ``data`` as the rank's range, moved from the ``model`` rank that
    holds it (``ctx.slice_holder``), in decode (zamba2's Mamba2
    ``in_proj`` among them) and, for gemma3, in a one-sequence training
    step too: logits, caches, states and every gradient as on plain
    tensors (fp32)."""
    got = _case(runs, "one_slot")[arch]
    assert got["slice_moves"] > 0, got
    assert got["logit_gap"] < 1e-4, got
    for k in ("k_gap", "v_gap", "state_gap"):
        if k in got:
            assert got[k] < 1e-4, (k, got)
    assert got["repeated"] == [], got
    grads = got["grads"]
    assert max(grads["grad_gap"].values()) < PARAM_TOL, grads
    assert grads["logit_gap"] < 1e-4, grads
    if arch == "gemma3-1b":
        assert grads["slice_moves"] > 0, grads


@pytest.mark.parametrize("tag", sorted(sharding_ranks.MAMBA_2D))
def test_mamba2_heads_split_on_the_2d_mesh(runs, tag):
    """The Mamba2 block on each ``model`` rank's range of the heads on the
    2x4 mesh under ``2d`` (``ssm._mamba_heads``): smoke Mamba2 with 6
    heads (2 a rank on ranks 0-2, none on rank 3) and ``in_proj`` whole
    over ``model``, and smoke zamba2 with ``in_proj`` split over it.  A
    prefill and 3 decode ticks against plain tensors (logits and the
    decode states, at the prefill/decode tolerance above), every SSD op
    call of rank 0 on its plain 2 heads, no product repeated on a mesh
    dim's ranks."""
    got = _case(runs, "mamba_2d")[tag]
    assert got["scan_heads"] and all(c == [False, 2]
                                     for c in got["scan_heads"]), got
    assert got["logit_gap"] < 1e-4, got
    assert got["state_gap"] < 1e-4, got
    assert got["repeated"] == [], got


@pytest.mark.parametrize("tag", sorted(sharding_ranks.MAMBA_2D))
def test_mamba2_heads_split_gradients_match(runs, tag):
    """The same blocks in a training step's loss under ``2d``: every
    parameter's gradient (the B and C columns' partial sums over
    ``model``, the norm's sum of squares, the columns each rank took from
    another's shard) against plain tensors at the parameter tolerance."""
    got = _case(runs, "mamba_2d")[tag]["grads"]
    assert got["scan_heads"] and all(c == [False, 2]
                                     for c in got["scan_heads"]), got
    assert got["logit_gap"] < LOSS_TOL, got
    assert got["grad_scale"] > 0
    for name, gap in got["grad_gap"].items():
        assert gap < PARAM_TOL, (name, got)


def test_dp_kv_heads_gradients_match(runs):
    """A ``dp`` step's gradients of smoke qwen3, whose 2 KV heads do not
    divide ``model=4``, with the batch over the whole 2x4 mesh: every
    gradient at the parameter tolerance, and no attention projection's
    gradient all-reduced whole (each gathered per shard for the
    microbatch, its gradient reduce-scattered back)."""
    got = _case(runs, "dp_kv")
    assert got["kv_heads"] == 2, got
    assert got["whole_reduced"] == [], got["whole_reduced"]
    assert got["logit_gap"] < LOSS_TOL, got
    assert got["grad_scale"] > 0
    for name, gap in got["grad_gap"].items():
        assert gap < PARAM_TOL, (name, got)


@pytest.mark.parametrize("split, placements", [
    ("model", ["Shard(1)", "Shard(2)"]),
    ("whole_mesh", ["Shard(2)", "Shard(2)"]),
    ("data", ["Shard(2)", "Shard(3)"]),
    ("ragged", ["Shard(1)", "Shard(2)"]),
    ("window", ["Shard(1)", "Shard(2)"]),
    ("ragged_window", ["Shard(1)", "Shard(2)"])])
def test_decode_with_the_sequence_split(runs, split, placements):
    """Prefill and 4 decode ticks with the KV cache's sequence split over
    the mesh (2 KV heads cannot split over ``model=4``; one slot cannot
    split over 'data'), each rank reading its own range from softmax
    partials: logits and both caches as the plain path's, at the
    prefill/decode tolerance above.  ``ragged``: slots of lengths 2, 11,
    5 and 8, so that some ranks hold no live key of a slot; ``window``:
    smoke gemma3, a window of 8 on every other layer (with those lengths
    in ``ragged_window``)."""
    got = _case(runs, "decode_seq")[split]
    assert got["k_placements"] == placements, got
    assert got["logit_gap"] < 1e-4, got
    assert got["k_gap"] < 1e-4, got
    assert got["v_gap"] < 1e-4, got


@pytest.mark.parametrize("mesh, heads", [("4x2", (2, 1)),
                                          ("2x4", (1, 1))])
def test_head_split_prefill_matches_single_device(runs, mesh, heads):
    """Smoke qwen3's prefill with its 4 query heads split over ``model``:
    every flash call runs on a rank's plain shard with ``heads`` (query,
    KV) heads (2x4: one query head against a slice of the gathered KV
    heads), and the logits are the plain path's, at the prefill/decode
    tolerance above."""
    got = _case(runs, "prefill_heads")[mesh]
    assert got["calls"], got
    assert all(c == [False, *heads] for c in got["calls"]), got
    assert got["logit_gap"] < 1e-4, got


def test_head_split_gradients_sum_over_shared_kv_heads(runs):
    """The loss's gradients of ``wq``, ``wk`` and ``wv`` on the 2x4 mesh,
    where two ``model`` ranks read each KV head (its gradient a sum over
    them), against plain tensors, at the parameter tolerance above."""
    got = _case(runs, "grads_heads")
    assert got["calls"] and all(c == [False, 1, 1] for c in got["calls"]), \
        got
    assert len(got["grad_gap"]) == 6, got
    assert got["grad_scale"] > 0, got
    for name, gap in got["grad_gap"].items():
        assert gap < PARAM_TOL, (name, got)


def _zigzag_chunks(got):
    return [tuple(c) for c in got["offsets"] if c[0] == 2]


@pytest.mark.parametrize("tag", ["causal", "window"])
def test_zigzag_prefill_matches_single_device(runs, tag):
    """6 query heads over 2 KV heads on the 2x4 mesh: the heads do not
    divide ``model=4``, so each ``model`` rank takes two chunks of 2 of
    the 16 positions (``transformer._zigzag``), one op call a chunk at
    its ``q_offset`` (rank 0: positions 0-1 and 14-15); with a window of 5
    on the first layer, the last chunk's keys start at 10.  A prefill and
    2 ticks (logits, both caches) against plain tensors, at the
    tolerance above."""
    got = _case(runs, "zigzag")[tag]
    assert "error" not in got, got["error"]
    chunks = _zigzag_chunks(got)
    assert chunks[:2] == [(2, 2, 0), (2, 6, 4) if tag == "window"
                          else (2, 16, 14)], got["offsets"]
    assert (2, 16, 14) in chunks
    for key in ("logit_gap", "k_gap", "v_gap"):
        assert got[key] < 1e-4, (key, got)


@pytest.mark.parametrize("tag", ["causal", "window"])
def test_zigzag_gradients_match_single_device(runs, tag):
    """The loss's gradients of every parameter with the query sequence
    split as above (q's, k's and v's gradients partial sums over
    ``model``), and the logits of that forward, against plain tensors at
    the tolerances above."""
    got = _case(runs, "zigzag")[tag]
    grads = got["grads"]
    assert "error" not in grads, grads["error"]
    assert {tuple(c) for c in grads["offsets"]} == \
        {(2, 2, 0), (2, 16, 14)} | ({(2, 6, 4)} if tag == "window" else
                                    set()), grads["offsets"]
    assert grads["logit_gap"] < 1e-4, grads
    assert len(grads["grad_gap"]) == 24 and grads["grad_scale"] > 0
    for name, gap in grads["grad_gap"].items():
        assert gap < PARAM_TOL, (name, grads)


@pytest.mark.parametrize("profile, plan", [("2d", [[1], [0]]),
                                           ("dp", [[0], []]),
                                           ("sp", [[0], []])])
def test_per_shard_lookup_matches_single_device(runs, profile, plan):
    """The embedding lookup on each rank's shard of the table under
    ``2d`` (vocab over 'model', D over 'data': decode-sized tokens keep
    both split), ``dp`` and ``sp`` (vocab over both mesh dims: the inner
    one, 'model', is gathered, 'data' keeps its split): the logits and
    every gradient, the table's among them, against plain tensors, at
    the tolerances above."""
    got = _case(runs, "lookup")[profile]
    assert "error" not in got, got["error"]
    assert got["plan"] == plan, got["plan"]
    assert got["logit_gap"] < LOSS_TOL, got
    assert got["grad_scale"] > 0
    for name, gap in got["grad_gap"].items():
        assert gap < PARAM_TOL, (name, got)


@pytest.mark.parametrize("tag, placements", [
    ("2d_4x2", ["Shard(0)", "Shard(1)"]), ("2d_2x4", ["Shard(0)", "Shard(1)"]),
    ("dp_4x2", ["Shard(1)", "Shard(1)"])])
def test_per_shard_swiglu_matches_single_device(runs, tag, placements):
    """``layers.swiglu`` per shard: ``2d`` (F over 'model' kept split, D
    over 'data' gathered, the output a partial sum over 'model') and
    ``dp`` (the weights gathered whole, the rank's own tokens): its
    output and the gradients of x and the three weights within 1e-6 of
    the largest value (fp32 sums over F's slices in another order)."""
    got = _case(runs, "swiglu")[tag]
    assert got["placements"] == placements, got
    assert len(got["gaps"]) == 5
    for gap in got["gaps"]:
        assert gap <= 1e-6 * got["scale"], got


def test_constrain_outside_and_inside_a_mesh(runs):
    got = _case(runs, "constrain")
    assert got["outside_is_identity"]
    assert "escaped the sharding" in got["raised"], got
    assert got["placed"] == ["Shard(0)", "Replicate"], got


def test_production_mesh_needs_its_ranks(runs):
    got = _case(runs, "production_mesh")
    assert "needs 256 ranks" in got["False"], got
    assert "needs 512 ranks" in got["True"], got


def test_elastic_restore_8_to_4_devices(runs):
    """Saved from the 8-rank 4x2 mesh (gathered, written by rank 0),
    restored by 4 ranks onto a 2x2 mesh."""
    assert "error" not in runs.get("save", {}), runs.get("save")
    got = _case(runs, "elastic")
    assert got["step"] == 3
    assert got["param_gap"] < 1e-6, got
    assert got["moment_gap"] < 1e-6, got
    assert got["meshes"] == [[2, 2]], got
    # the trainer's restore-on-start takes the same shardings
    assert got["trainer_step"] == 3, got
    assert got["trainer_meshes"] == [[2, 2]], got
